"""The port's ``python -m kid_tpu_torch`` entry on the CPU
(``--device cpu``): case listing, an end-to-end run with the NetCDF sink
and checkpoint/resume (the scenarios of tests/test_cli.py), a 2-D run,
the fused driver switch, the constants-fingerprint guard, and the NetCDF
writer and fingerprint against the JAX package's."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from collections import namedtuple

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from kid_tpu.diag.registry import registry_from_run as j_registry_from_run
from kid_tpu.tables.cache import constants_fingerprint as j_fingerprint
from kid_tpu_torch.diag.registry import registry_from_run
from kid_tpu_torch.driver.cases import CASES
from kid_tpu_torch.driver.loop import (FUSED_DRIVER_ENV, KidState,
                                       StepOutputs, initial_state, simulate)
from kid_tpu_torch.micro.solver import device_tables
from kid_tpu_torch.tables.cache import constants_fingerprint, get_tables
from kid_tpu_torch.utils.checkpoint import RunCheckpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*argv, env_extra=None, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop(FUSED_DRIVER_ENV, None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "kid_tpu_torch", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _ok(out):
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def _read_nc(path, name):
    with netcdf_file(path, "r", mmap=False) as nc:
        return np.array(nc.variables[name][:])


def test_cli_list():
    out = _cli("list")
    _ok(out)
    for name in ("warm1", "mixed1", "aerosol1d", "cumulus2d"):
        assert name in out.stdout
    assert "published-spec" in out.stdout     # provenance shown


def test_cli_run_netcdf_and_resume(tmp_path):
    nc_path = str(tmp_path / "d.nc")
    ck = str(tmp_path / "ck")
    out = _cli("run", "warm1_recon", "--steps", "12", "--device", "cpu",
               "--profiles", "qc,qr", "--out", nc_path,
               "--checkpoint-dir", ck)
    _ok(out)
    with netcdf_file(nc_path, "r", mmap=False) as nc:
        assert nc.variables["qc"].shape[0] == 12
        assert "total_surface_ppt" in nc.variables
    out2 = _cli("run", "warm1_recon", "--steps", "24", "--device", "cpu",
                "--profiles", "qc", "--checkpoint-dir", ck, "--resume")
    _ok(out2)
    assert "resumed from checkpoint step 12" in out2.stdout
    assert RunCheckpointer(ck, "warm1_recon").steps() == [12, 24]


def test_cli_checkpointed_run_equals_one_run(tmp_path):
    one, parts = str(tmp_path / "one"), str(tmp_path / "parts")
    args = ("run", "warm1_recon", "--device", "cpu", "--profiles", "qc")
    _ok(_cli(*args, "--steps", "24", "--checkpoint-dir", one,
             "--out", str(tmp_path / "one.nc")))
    _ok(_cli(*args, "--steps", "12", "--checkpoint-dir", parts))
    _ok(_cli(*args, "--steps", "24", "--checkpoint-dir", parts, "--resume",
             "--out", str(tmp_path / "last.nc")))
    s1, want = RunCheckpointer(one, "warm1_recon").restore(device="cpu")
    s2, got = RunCheckpointer(parts, "warm1_recon").restore(device="cpu")
    assert s1 == s2 == 24 and isinstance(got, KidState)
    for f in KidState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    np.testing.assert_array_equal(_read_nc(tmp_path / "last.nc", "qc"),
                                  _read_nc(tmp_path / "one.nc", "qc")[12:])


def test_cli_refuses_resume_with_other_constants(tmp_path):
    ck = str(tmp_path / "ck")
    _ok(_cli("run", "warm1_recon", "--steps", "12", "--device", "cpu",
             "--profiles", "qc", "--checkpoint-dir", ck))
    meta = tmp_path / "ck" / "warm1_recon" / "meta.json"
    m = json.loads(meta.read_text())
    m["fingerprint"] = "0" * 16
    meta.write_text(json.dumps(m))
    out = _cli("run", "warm1_recon", "--steps", "24", "--device", "cpu",
               "--profiles", "qc", "--checkpoint-dir", ck, "--resume")
    assert out.returncode != 0
    assert "different microphysical constants" in out.stderr


def test_cli_fused_driver_run(tmp_path):
    args = ("run", "mixed1", "--steps", "12", "--device", "cpu",
            "--profiles", "qr,nwfa")
    _ok(_cli(*args, "--out", str(tmp_path / "default.nc")))
    out = _cli(*args, "--out", str(tmp_path / "fused.nc"),
               env_extra={FUSED_DRIVER_ENV: "1"})
    _ok(out)
    fused = {k: _read_nc(tmp_path / "fused.nc", k) for k in ("qr", "nwfa")}
    default = {k: _read_nc(tmp_path / "default.nc", k)
               for k in ("qr", "nwfa")}
    assert fused["qr"].shape == (12, 1, 120)
    assert np.isfinite(fused["qr"]).all()
    # the fused step advects nwfa too (ROADMAP.md, Queue 3), so nwfa shows
    # that the switch took the run through it; qr is the default path's
    np.testing.assert_array_equal(fused["qr"], default["qr"])
    assert not np.array_equal(fused["nwfa"], default["nwfa"])


def test_cli_runs_2d_case(tmp_path):
    """cumulus2d at its own width (64 x 60): the streams written are
    ``simulate``'s on the same state, and ``--ncol`` leaves it as it is."""
    nc_path = str(tmp_path / "x.nc")
    out = _cli("run", "cumulus2d", "--steps", "3", "--device", "cpu",
               "--ncol", "8", "--profiles", "qc,theta,dqv_mphys",
               "--out", nc_path)
    _ok(out)
    assert "nx=64 nz=60" in out.stdout
    case = CASES["cumulus2d"]
    tabs = device_tables(get_tables(iiwarm=True), torch.float32, "cpu")
    _, want = simulate(initial_state(case, torch.float32, "cpu"), tabs, case,
                       3, ("qc", "theta", "dqv_mphys"), device="cpu")
    for k in ("qc", "theta", "dqv_mphys"):
        got = _read_nc(nc_path, k)
        assert got.shape == (3, 64, 60), k
        np.testing.assert_array_equal(got, want.profiles[k].numpy(),
                                      err_msg=k)
    np.testing.assert_array_equal(_read_nc(nc_path, "surface_ppt_for_rain_x"),
                                  want.ppt_rain.numpy())


def test_constants_fingerprint_matches_jax():
    assert constants_fingerprint() == j_fingerprint()


@pytest.mark.parametrize("nx", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_netcdf_byte_identical_to_jax_writer(tmp_path, dtype, nx):
    rng = np.random.default_rng(7)
    n_steps, nz = 5, 6
    ppt = {k: rng.random((n_steps, nx)).astype(dtype)
           for k in ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice")}
    profs = {k: rng.random((n_steps, nx, nz)).astype(dtype)
             for k in ("qc", "prr_wau", "dqv_mphys")}
    if nx == 1:
        profs = {k: v[:, 0] for k, v in profs.items()}
    JStreams = namedtuple("JStreams", StepOutputs._fields)
    want = j_registry_from_run("mixed1", JStreams(**ppt, profiles=profs), nx)
    got = registry_from_run("mixed1", StepOutputs(
        **{k: torch.as_tensor(v) for k, v in ppt.items()},
        profiles={k: torch.as_tensor(v) for k, v in profs.items()}), nx)
    assert got.names() == want.names()
    want.to_netcdf(str(tmp_path / "jax.nc"))
    got.to_netcdf(str(tmp_path / "port.nc"))
    assert ((tmp_path / "port.nc").read_bytes()
            == (tmp_path / "jax.nc").read_bytes())
