"""A configuration file states the whole initial state of every case the
program defines, and ``drive.program_case`` refuses one that misstates
it; the committed configurations' initial profiles keep their bits."""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from case_files import SOUNDINGS, config_of, is_piecewise
from kidbench import drive, inputs
from kidbench.manifest import find_cell
from kidbench.reference.kid import FIELDS, KidCase, sounding


def program_cases():
    from kid_tpu_torch.driver.cases import CASES
    return CASES


# Every name of the program's CASES, as its cases module lists them.
NAMES = ("warm1", "warm1_recon", "mixed1", "deep1", "aerosol1d",
         "cumulus2d", "orographic2d")


def test_the_helper_states_every_case_the_program_defines():
    assert set(program_cases()) == set(NAMES) == set(SOUNDINGS)


@pytest.mark.parametrize("name", NAMES)
def test_a_stated_case_starts_where_the_program_starts(name):
    """With no noise, the benchmark's initial state of a configuration
    written from the case is the program's own, in float64: bit for bit
    where the case's soundings are linear, exp or const, to 1e-13 where
    one is piecewise.  The number fills divide by rho0, which the
    reference's grid rounds in another order (``287.04 * theta * exner``
    against the program's ``287.04 * (theta * exner)``): within 1e-15,
    3 ulps at most."""
    from kid_tpu_torch.driver.loop import initial_state
    case = program_cases()[name]
    cfg = config_of(case, nx=case.nx if case.dx else 3)
    ref = KidCase(cfg)
    assert drive.program_case(cfg).micro.is_aerosol_aware == (
        case.micro.is_aerosol_aware)
    got = inputs.initial_state(ref, cfg, 2 ** 31 + 12345, torch.float64,
                               "cpu")
    want = initial_state(dataclasses.replace(case, nx=cfg["nx"]),
                         torch.float64, "cpu")
    for f, g in zip(FIELDS, got):
        g, w = g.numpy(), getattr(want, f).numpy()
        if is_piecewise(cfg):
            np.testing.assert_allclose(g, w, rtol=1e-13, atol=0, err_msg=f)
        elif f in cfg or not w.any():
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-15, atol=0, err_msg=f)


def altered(cfg: dict, field: str, rel: float = 1e-6) -> dict:
    spec = cfg[field]
    if spec["kind"] == "piecewise":
        spec["values"][1] *= 1.0 + rel
    else:
        spec["at_0"] *= 1.0 + rel
    return cfg


def fault(name: str) -> dict:
    return config_of(program_cases()[name])


FAULTS = {
    "mixed1.theta+1e-6": (lambda: altered(fault("mixed1"), "theta"),
                          "theta"),
    "warm1.qv+1e-6@740m": (lambda: altered(fault("warm1"), "qv"),
                           "qv = .* at level 30 "),
    "deep1.theta+1e-6@12km": (lambda: altered(fault("deep1"), "theta"),
                              "theta"),
    "aerosol1d.nwfa+1e-6": (lambda: altered(fault("aerosol1d"), "nwfa"),
                            "nwfa"),
    "aerosol1d.nifa+1e-6": (lambda: altered(fault("aerosol1d"), "nifa"),
                            "nifa"),
    "aerosol1d.without_nwfa": (
        lambda: {k: v for k, v in fault("aerosol1d").items()
                 if k != "nwfa"}, "nwfa"),
    "warm1.with_mixed1_qv": (
        lambda: {**fault("warm1"), "qv": dict(SOUNDINGS["mixed1"]["qv"])},
        "qv"),
    "aerosol1d.not_aerosol_aware": (
        lambda: {**fault("aerosol1d"), "scheme": {
            **fault("aerosol1d")["scheme"], "is_aerosol_aware": False}},
        "is_aerosol_aware"),
}


@pytest.mark.parametrize("name", FAULTS)
def test_program_case_refuses_a_misstated_case(name):
    make, match = FAULTS[name]
    with pytest.raises(ValueError, match=match):
        drive.program_case(make())


def test_a_gap_under_the_tolerance_passes():
    cfg = altered(fault("mixed1"), "theta", rel=1e-14)
    assert drive.program_case(cfg).name == "mixed1"


def test_a_piecewise_sounding_is_np_interp_and_flat_beyond_its_ends():
    spec = {"kind": "piecewise", "z_m": [100.0, 200.0, 400.0],
            "values": [1.0, 3.0, 2.0]}
    z = np.array([0.0, 100.0, 150.0, 300.0, 400.0, 900.0])
    np.testing.assert_array_equal(sounding(spec, z),
                                  [1.0, 1.0, 2.0, 2.5, 2.0, 2.0])
    for bad in ({**spec, "z_m": [100.0, 100.0, 400.0]},
                {**spec, "values": [1.0, 3.0]}):
        with pytest.raises(ValueError, match="piecewise"):
            sounding(bad, z)


# sha256 of the float64 initial profiles, FIELDS in order, of each
# committed configuration, as the harness made them before a file could
# state nwfa, nifa or a piecewise sounding.
DIGESTS = {
    "mixed1.loop":
        "341b05231277f209c7615bc96a6452b656dd9a9b998f76542c558e79672526da",
    "cumulus2d.loop":
        "43aac386a61c2b5e629956bbcacd43f86c2425e1a869b99f5fda2483831d5921",
    "cumulus2d_weak4.loop":
        "43aac386a61c2b5e629956bbcacd43f86c2425e1a869b99f5fda2483831d5921",
}


@pytest.mark.parametrize("cell", DIGESTS)
def test_the_committed_configurations_start_where_they_did(cell):
    prof = KidCase(find_cell(cell).cfg).initial_profiles()
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(np.ascontiguousarray(prof[f], np.float64).tobytes())
    assert h.hexdigest() == DIGESTS[cell]


@pytest.mark.parametrize("name", NAMES)
def test_the_work_of_every_stated_case_can_be_counted(name, monkeypatch):
    """``kidbench.work`` counts a step of every case (the aerosol-aware
    one given its w, as the program's step gives it), here from the
    state after a few steps at a few columns."""
    from kidbench import work
    monkeypatch.setattr(work, "STATE_STEPS", 4)
    cfg = config_of(program_cases()[name], dtype="float32")
    ops = work.count_ops(cfg, 4)
    assert ops > 0
    if name == "aerosol1d":
        plain = work.count_ops(config_of(program_cases()["mixed1"],
                                         dtype="float32"), 4)
        assert ops > plain
