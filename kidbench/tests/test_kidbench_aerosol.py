"""The aerosol-aware cell ``aerosol1d.loop`` on the CPU at test size: its
configuration states the program's aerosol1d and its frozen work, the
program's float64 loop follows the reference from seeded columns over a
10-step check segment, and the comparison through ``loop_check10``'s
segments passes the program and fails the control and every planted loop
fault.  The control at the cell's own size on the card is
``test_kidbench_card.py``'s, whose cells are those of ``BENCHMARK.json``.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from kidbench import drive, inputs, work
from kidbench.manifest import find_cell
from kidbench.reference import kid
from kidbench.reference.tables import get_tables as frozen_tables
from test_kidbench_faults import LOOP_FAULTS, SEED

CELL = "aerosol1d.loop"


def small():
    """The cell at 8 columns over 40 steps, 5-step chunks, the traffic's
    10-step checks at steps 0 and 20."""
    cell = find_cell(CELL)
    cfg, tr = dict(cell.cfg), dict(cell.traffic)
    cfg.update(nx=8, t_final=80.0)
    tr.update(chunk_steps=5, checks_at_share=[0.0, 0.5],
              sample={"columns": 6, "blocks": 2, "block_columns": 4})
    return cell._replace(cfg=cfg, traffic=tr)


def run_small(control=False):
    out = drive.run_cell(small(), SEED, 0.3, False, torch.device("cpu"),
                         time.perf_counter(), control=control, workers=2)
    return out, all(v <= lim for v, lim in out.checks.values())


def test_the_configuration_is_the_programs_aerosol1d():
    cell = find_cell(CELL)
    cfg = cell.cfg
    case = drive.program_case(cfg)
    assert case.name == "aerosol1d" and case.micro.is_aerosol_aware
    assert (cfg["nx"], cfg["nz"], cfg["dtype"]) == (65536, 120, "float32")
    assert cfg["reduced"] == ["nx"] and "nx" in cfg["assumed"]
    assert cell.traffic["check_steps"] == 10
    assert cell.traffic["chunk_steps"] == 50


def test_the_frozen_work_recounts():
    cfg = find_cell(CELL).cfg
    assert work.work_block(cfg) == cfg["work"]


def test_the_float64_loop_follows_the_reference_on_seeded_columns():
    """10 steps (the traffic's check) from step 150, where ice, snow and
    graupel are there and CCN activate, of seeded noisy columns: the
    program in float64 on the CPU and the reference agree to rounding on
    every field, nc, nwfa and nifa among them."""
    from kid_tpu_torch.driver.cases import CASES
    from kid_tpu_torch.driver.loop import KidState, simulate
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    cfg = dict(find_cell(CELL).cfg, nx=4)
    ref = kid.KidCase(cfg)
    case = dataclasses.replace(CASES["aerosol1d"], nx=cfg["nx"])
    state = KidState(*inputs.initial_state(ref, cfg, SEED, torch.float64,
                                           "cpu"))
    assert not torch.equal(state.theta[0], state.theta[1])
    tables = device_tables(get_tables(iiwarm=False), torch.float64, "cpu")
    i0, n = 150, 10
    st, _ = simulate(state, tables, case, i0, device="cpu")
    out, streams = simulate(st, tables, case, n, istep0=i0, device="cpu")
    cols = np.arange(cfg["nx"])
    before = {f: getattr(st, f).numpy() for f in kid.FIELDS}
    got, kept, ppt = kid.advance(ref, kid.local_solver(frozen_tables(False)),
                                 before, cols, i0, n)
    for f in kid.FIELDS:
        want = getattr(out, f).numpy()[kept]
        assert not np.array_equal(want, before[f]), f
        np.testing.assert_allclose(got[f], want, rtol=1e-9, atol=1e-12,
                                   err_msg=f)
    np.testing.assert_allclose(
        ppt["rain"], streams.ppt_rain.numpy()[:, kept].sum(0), rtol=1e-9,
        atol=1e-15)


def test_the_program_and_the_control_through_the_10_step_checks():
    out, correct = run_small(control=True)
    assert correct, out.checks
    assert out.where.split("/")[0].split("@")[0] in ("step0+10", "step20+10")
    assert out.control["worst_gap"] > 3 * out.checks["worst_gap"][1]


@pytest.mark.parametrize("fault", sorted(LOOP_FAULTS))
def test_a_broken_aerosol_loop_is_not_correct(monkeypatch, fault):
    from kid_tpu_torch.driver import loop
    real = loop.simulate

    def broken(st, *a, **k):
        out, streams = real(st, *a, **k)
        return LOOP_FAULTS[fault](st, out), streams

    monkeypatch.setattr(loop, "simulate", broken)
    out, correct = run_small()
    assert not correct, out.checks

