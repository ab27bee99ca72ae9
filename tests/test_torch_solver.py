"""PyTorch port's microphysics step against the JAX package, on the CPU.

The same seeded inputs (numpy) go through ``kid_tpu``'s inline solver
(and, once, its Pallas kernel in interpret mode) and through
``kid_tpu_torch``'s plain path, in float64.  Tolerance: the knife-edge
model of ``tests/test_pallas.py::_assert_equiv`` with the noise threshold
tightened to 1e-8 (at most 0.5% of cells over it, flips counted as
there), precip to rtol 1e-8.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kid_tpu.config import MicroConfig as JConfig
from kid_tpu.micro import solver as JS
from kid_tpu.micro.pallas_step import fused_step as j_fused_step
from kid_tpu.micro.state import ColumnState as JState
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu_torch.config import MicroConfig
from kid_tpu_torch.convert import state_from_numpy, tables_from_numpy
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro.fused_step import fused_step, fused_step_ref

torch.set_num_threads(2)

NOISE = 1e-8


def _make_batch(ncol=12, nz=48, seed=0, ztop=12000.0, rain_scale=1.0):
    """Numpy twin of tests/test_pallas.py::_make_batch (float64)."""
    rng = np.random.default_rng(seed)
    zc = (np.arange(nz) + 0.5) * (ztop / nz)
    p = 101325.0 * np.exp(-zc / 8500.0)
    t = np.maximum(288.0 - 0.0065 * zc, 210.0)
    qv = 0.012 * np.exp(-zc / 2500.0)
    rho = 0.622 * p / (287.04 * t * (qv + 0.622))

    def b(x, scale=1.0):
        arr = np.broadcast_to(x, (ncol, nz)).copy()
        arr *= (1.0 + 0.2 * rng.random((ncol, 1)))
        return np.maximum(arr * scale, 0.0)

    cloud = np.where((zc > 500) & (zc < 3000), 1.0e-3, 0.0)
    rain = np.where(zc < 2000, 3.0e-4 * rain_scale, 0.0)
    ice = np.where(zc > 6000, 5.0e-5, 0.0)
    snow = np.where(zc > 5000, 2.0e-4, 0.0)
    state = dict(
        t=b(t), qv=b(qv), qc=b(cloud), qi=b(ice), qr=b(rain),
        qs=b(snow), qg=b(snow, 0.5),
        ni=b(np.where(ice > 0, 1.0e4, 0.0)),
        nr=b(np.where(rain > 0, 1.0e5, 0.0)),
        nc=b(100.0e6 / rho), nwfa=b(300.0e6 / rho), nifa=b(1.0e6 / rho))
    pres = np.broadcast_to(p, (ncol, nz)).copy()
    dzq = np.full((ncol, nz), ztop / nz)
    return state, pres, dzq


def _jax_inputs(state, pres, dzq):
    return (JState(**{k: jnp.asarray(v) for k, v in state.items()}),
            jnp.asarray(pres), jnp.asarray(dzq))


def _torch_inputs(state, pres, dzq):
    st = state_from_numpy(JState(**state), device="cpu",
                          dtype=torch.float64)
    return st, torch.as_tensor(pres), torch.as_tensor(dzq)


def _flat(res, want_rates):
    st, ppt, diag = res
    out = {f: np.asarray(getattr(st, f)) for f in st._fields}
    if want_rates:
        out.update({k: np.asarray(v) for k, v in diag.items()})
    return out, [np.asarray(p) for p in ppt]


def assert_equiv(got, want, noise=NOISE):
    """tests/test_pallas.py::_assert_equiv with a noise threshold."""
    parent = {"nc": "qc", "ni": "qi", "nr": "qr"}
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k], np.float64), np.asarray(want[k],
                                                           np.float64)
        assert a.shape == b.shape, k
        if k in parent and parent[k] in want:
            pa = np.asarray(got[parent[k]])
            pb = np.asarray(want[parent[k]])
            ghost = (np.abs(pa) < 1e-9) & (np.abs(pb) < 1e-9)
            a = np.where(ghost, 0.0, a)
            b = np.where(ghost, 0.0, b)
        scale = np.abs(b) + 1e-3 * np.abs(b).max() + 1e-30
        rel = np.abs(a - b) / scale
        n_noise = int((rel > noise).sum())
        n_flip = int((rel > 0.25).sum())
        assert n_noise <= max(3, 0.005 * rel.size), (k, n_noise)
        assert n_flip <= max(2, 0.002 * rel.size), (k, float(rel.max()))


def _jax_inline(jstate, jpres, jdzq, jcfg, dt_f, want_rates):
    tables = JS.device_tables(j_get_tables(iiwarm=jcfg.iiwarm), jnp.float64)
    pro, idx = JS._prologue(jstate, jpres, jcfg)
    tv = JS._table_stage(pro, idx, tables, jcfg, dt_f)
    pro.update(tv)
    p8 = JS.rates_and_tendencies(pro, jcfg, dt_f, want_rates)
    return JS._post_rates(jstate, jpres, None, jdzq, p8, pro, tables, jcfg,
                          dt_f, want_rates)


def _port_step(st, pres, dzq, cfg, dt_f, want_rates):
    tables = tables_from_numpy(j_get_tables(iiwarm=cfg.iiwarm),
                               torch.float64, "cpu")
    return S.batched_microphysics(st, pres, None, dzq, dt_f, tables, cfg,
                                  want_rates, device="cpu")


@pytest.mark.parametrize("iiwarm,want_rates", [
    (False, True), (False, False), (True, True), (True, False)],
    ids=["mixed-rates", "mixed", "warm-rates", "warm"])
def test_solver_step_matches_jax(iiwarm, want_rates):
    batch = _make_batch()
    want = _flat(_jax_inline(*_jax_inputs(*batch), JConfig(iiwarm=iiwarm),
                             10.0, want_rates), want_rates)
    got = _flat(_port_step(*_torch_inputs(*batch), MicroConfig(iiwarm=iiwarm),
                           10.0, want_rates), want_rates)
    assert_equiv(got[0], want[0])
    for pg, pw in zip(got[1], want[1]):
        np.testing.assert_allclose(pg, pw, rtol=1e-8, atol=1e-20)


def test_deep_convection_substeps_match_jax(monkeypatch):
    """Heavy rain on 25 m layers with a 60 s step: more than 10
    sedimentation substeps in some columns."""
    batch = _make_batch(ncol=6, nz=48, seed=5, ztop=1200.0, rain_scale=20.0)
    seen = []
    sweep = S._sweep

    def spy(n_loop, *args):
        seen.append(int(n_loop.max()))
        return sweep(n_loop, *args)

    monkeypatch.setattr(S, "_sweep", spy)
    want = _flat(_jax_inline(*_jax_inputs(*batch), JConfig(iiwarm=False),
                             60.0, True), True)
    got = _flat(_port_step(*_torch_inputs(*batch), MicroConfig(iiwarm=False),
                           60.0, True), True)
    assert max(seen) > 10, seen
    assert_equiv(got[0], want[0])
    for pg, pw in zip(got[1], want[1]):
        np.testing.assert_allclose(pg, pw, rtol=1e-8, atol=1e-20)


def test_fused_step_ref_matches_pallas_interpret():
    """The port's plain version of the kernel against the JAX Pallas
    kernel in interpret mode, on 7 columns (a padded block there)."""
    cfg, jcfg, dt_f = MicroConfig(iiwarm=False), JConfig(iiwarm=False), 10.0
    batch = _make_batch(ncol=7, nz=32, seed=2)
    jstate, jpres, jdzq = _jax_inputs(*batch)
    tables = JS.device_tables(j_get_tables(iiwarm=False), jnp.float64)
    pro, idx = JS._prologue(jstate, jpres, jcfg)
    jtv = JS._table_stage(pro, idx, tables, jcfg, dt_f)
    want = _flat(j_fused_step(jstate, jpres, jdzq, jtv, jcfg, dt_f, True,
                              interpret=True), True)
    st, pres, dzq = _torch_inputs(*batch)
    tv = {k: torch.as_tensor(np.array(v)) for k, v in jtv.items()}
    assert tuple(tv) == S.tv_keys(cfg)
    got = _flat(fused_step_ref(st, pres, dzq, tv, cfg, dt_f, True), True)
    assert_equiv(got[0], want[0])
    for pg, pw in zip(got[1], want[1]):
        np.testing.assert_allclose(pg, pw, rtol=1e-8, atol=1e-20)


def test_table_stage_matches_jax():
    """The torch gathers of the table stage against the reference's
    banded and one-hot lookups (exact selections of the same cells)."""
    cfg, jcfg, dt_f = MicroConfig(iiwarm=False), JConfig(iiwarm=False), 10.0
    batch = _make_batch(seed=4)
    jstate, jpres, _ = _jax_inputs(*batch)
    tables = JS.device_tables(j_get_tables(iiwarm=False), jnp.float64)
    pro, idx = JS._prologue(jstate, jpres, jcfg)
    want = JS._table_stage(pro, idx, tables, jcfg, dt_f)
    st, pres, _ = _torch_inputs(*batch)
    ttables = tables_from_numpy(j_get_tables(iiwarm=False), torch.float64,
                                "cpu")
    tpro, tidx = S._prologue(st, pres, cfg)
    got = S._table_stage(tpro, tidx, ttables, cfg, dt_f)
    assert set(got) == set(want)
    assert_equiv({k: v.numpy() for k, v in got.items()},
                 {k: np.asarray(v) for k, v in want.items()})


def test_fused_step_rejects_bad_inputs():
    cfg = MicroConfig(iiwarm=True)
    st, pres, dzq = _torch_inputs(*_make_batch(ncol=3, nz=8))
    tv = {"ef_rw": torch.zeros(3, 8, dtype=torch.float32)}
    with pytest.raises(ValueError):
        fused_step(st, pres, dzq, tv, cfg, 1.0, False)
    tv = {k: torch.zeros(3, 8, dtype=torch.float64) for k in S.TV_ICE}
    with pytest.raises(ValueError, match="non-aerosol"):
        fused_step(st, pres, dzq, tv, MicroConfig(is_aerosol_aware=True),
                   1.0, False)

