"""PyTorch port's aerosol-aware path against the JAX package, on the CPU.

The same seeded inputs (numpy, float64) go through ``kid_tpu`` and
``kid_tpu_torch``: the aerosol functions (rtol 1e-12; Koop 1e-10, see
there), the aerosol tables, the aerosol prologue, each function of the
split step against the JAX split kernels run in interpret mode, the
lookup stage between them, and one whole step.  Tolerance for the step
functions: the knife-edge model of ``test_torch_solver.assert_equiv`` at
noise 1e-8, precip rtol 1e-8.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kid_tpu import constants as jc
from kid_tpu.config import MicroConfig as JConfig
from kid_tpu.micro import aerosol as jaero
from kid_tpu.micro import solver as JS
from kid_tpu.micro.pallas_step import fused_post as j_fused_post
from kid_tpu.micro.pallas_step import fused_rates as j_fused_rates
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu_torch.config import MicroConfig
from kid_tpu_torch.convert import tables_from_numpy
from kid_tpu_torch.micro import aerosol as taero
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro.split_step import fused_post, fused_rates
from test_torch_solver import (_jax_inputs, _make_batch, _torch_inputs,
                               assert_equiv)

torch.set_num_threads(2)

DT = 10.0
CFGS = {"mixed": dict(iiwarm=False, is_aerosol_aware=True),
        "warm": dict(iiwarm=True, is_aerosol_aware=True)}


def _rng_vals(seed, n, lo, hi, log=False):
    rng = np.random.default_rng(seed)
    if log:
        return 10.0 ** rng.uniform(np.log10(lo), np.log10(hi), n)
    return rng.uniform(lo, hi, n)


def _both(fn_t, fn_j, *arrays, **kw):
    got = fn_t(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                 for a in arrays], **kw)
    want = fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in arrays], **kw)
    return np.asarray(got), np.asarray(want)


@pytest.mark.parametrize("species,da", [("r", 0.04e-6), ("r", 0.8e-6),
                                        ("s", 0.04e-6), ("s", 0.8e-6),
                                        ("g", 0.04e-6), ("g", 0.8e-6)])
def test_eff_aero_matches(species, da):
    n = 3000
    d = _rng_vals(0, n, 5e-5, 5e-3, log=True)
    visc = _rng_vals(1, n, 1.3e-5, 1.8e-5)
    rho = _rng_vals(2, n, 0.3, 1.3)
    temp = _rng_vals(3, n, 210.0, 300.0)
    got, want = _both(lambda *a: taero.eff_aero(*a[:1], da, *a[1:], species),
                      lambda *a: jaero.eff_aero(*a[:1], da, *a[1:], species),
                      d, visc, rho, temp)
    assert (want > 1e-5).any() and (want < 1.0).any()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_ice_nucleation_and_delta_p_match():
    n = 3000
    tempc = _rng_vals(4, n, -60.0, -1.0)
    rho = _rng_vals(5, n, 0.3, 1.3)
    nifa = _rng_vals(6, n, 1e3, 1e8, log=True)
    qv = _rng_vals(7, n, 1e-6, 1e-3, log=True)
    got, want = _both(taero.ice_demott, jaero.ice_demott, tempc, qv, qv, qv,
                      rho, nifa)
    assert (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-12)

    # Koop: water activities where the freezing probability is neither
    # ~0 (where 1 - exp(-x) cancels) nor saturated at 1
    temp = _rng_vals(8, n, 195.0, 240.0)
    mu_diff = (210368.0 + 131.438 * temp - 3.32373e6 / temp
               - 41729.1 * np.log(temp))
    satw = np.exp(mu_diff / (8.314 * temp)) + _rng_vals(9, n, 0.315, 0.335)
    naero = _rng_vals(10, n, 1e6, 1e9, log=True)
    got, want = _both(taero.ice_koop, jaero.ice_koop, temp, qv, qv / satw,
                      naero, DT)
    assert (want > 0).all() and (want < 1000.0e3).any()
    # rtol 1e-10, not 1e-12: mu_diff and the J-rate polynomial each cancel
    # two to three digits, so the 1-ulp differences between torch's and
    # XLA's log/exp grow to ~7e-12 here
    np.testing.assert_allclose(got, want, rtol=1e-10)

    yy = _rng_vals(11, n, -1.0, 4.0)
    y1, y2 = np.full(n, 0.5), np.full(n, 2.5)
    aa, bb = np.full(n, 0.1), np.full(n, 3.0)
    got, want = _both(taero.delta_p, jaero.delta_p, yy, y1, y2, aa, bb)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_activ_ncloud_matches_on_a_random_table():
    """A random seeded activation table: this variant's table is all
    ones, which would hide a wrong corner or interpolation weight."""
    rng = np.random.default_rng(12)
    act = rng.uniform(0.05, 1.0, np.shape(j_get_tables(False).tnccn_act))
    corners_j = JS._tnccn_corners(act)
    corners_t = S._tnccn_corners(act)
    np.testing.assert_array_equal(corners_t, corners_j)
    n = 4000
    tt = _rng_vals(13, n, 230.0, 315.0)
    ww = _rng_vals(14, n, 1e-3, 150.0, log=True)
    nccn = _rng_vals(15, n, 1e6, 2e10, log=True)
    got = taero.activ_ncloud(torch.as_tensor(tt), torch.as_tensor(ww),
                             torch.as_tensor(nccn),
                             torch.as_tensor(corners_t)).numpy()
    want = np.asarray(jaero.activ_ncloud(jnp.asarray(tt), jnp.asarray(ww),
                                         jnp.asarray(nccn),
                                         jnp.asarray(corners_j)))
    assert np.std(want / nccn) > 0.05
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_device_tables_aerosol_fields_match():
    want = JS.device_tables(j_get_tables(iiwarm=False), jnp.float64)
    got = tables_from_numpy(j_get_tables(iiwarm=False), torch.float64, "cpu")
    for f in ("tnc_wev", "tnccn_act", "tnccn_corners"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def _batch(ncol=12, nz=48, seed=3):
    batch = _make_batch(ncol=ncol, nz=nz, seed=seed)
    w = np.random.default_rng(seed + 100).uniform(0.01, 4.0, (ncol, nz))
    return batch, w


def _port_tv(st, pres, cfg):
    tables = tables_from_numpy(j_get_tables(iiwarm=cfg.iiwarm),
                               torch.float64, "cpu")
    pro, idx = S._prologue(st, pres, cfg)
    return tables, S._table_stage(pro, idx, tables, cfg, DT)


def _jax_tv(jst, jpres, jcfg):
    tables = JS.device_tables(j_get_tables(iiwarm=jcfg.iiwarm), jnp.float64)
    pro, idx = JS._prologue(jst, jpres, jcfg)
    return tables, JS._table_stage(pro, idx, tables, jcfg, DT)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_aerosol_prologue_matches_jax(name):
    (batch, _) = _batch()
    jcfg, cfg = JConfig(**CFGS[name]), MicroConfig(**CFGS[name])
    jpro, jidx = JS._prologue(*_jax_inputs(*batch)[:2], jcfg)
    st, pres, _ = _torch_inputs(*batch)
    pro, idx = S._prologue(st, pres, cfg)
    assert {"nwfa", "nifa"} <= set(pro)
    common = sorted(set(pro) & set(jpro))
    assert len(common) >= 40
    assert_equiv({k: pro[k].numpy() for k in common},
                 {k: np.asarray(jpro[k]) for k in common})
    np.testing.assert_allclose(pro["nc"].numpy(), np.asarray(jpro["nc"]),
                               rtol=1e-12)
    for k in jidx:
        np.testing.assert_array_equal(idx[k].numpy(), np.asarray(jidx[k]),
                                      err_msg=k)


@pytest.mark.parametrize("name,want_rates", [
    ("mixed", True), ("mixed", False), ("warm", True)],
    ids=["mixed-rates", "mixed", "warm-rates"])
def test_fused_rates_ref_matches_pallas_interpret(name, want_rates):
    (batch, _) = _batch(ncol=7, nz=32, seed=2)
    jcfg, cfg = JConfig(**CFGS[name]), MicroConfig(**CFGS[name])
    jst, jpres, _ = _jax_inputs(*batch)
    _, jtv = _jax_tv(jst, jpres, jcfg)
    want = _np(j_fused_rates(jst, jpres, jtv, jcfg, DT, want_rates,
                             interpret=True))
    st, pres, _ = _torch_inputs(*batch)
    tv = {k: torch.as_tensor(np.array(v)) for k, v in jtv.items()}
    got = fused_rates(st, pres, tv, cfg, DT, want_rates)
    assert set(got) == set(want)
    assert_equiv({k: v.numpy() for k, v in got.items()}, want)
    if name == "mixed":
        assert np.abs(want["nwfaten"]).max() > 0
        assert np.abs(want["nifaten"]).max() > 0


def _jax_p8_aux(batch, w, jcfg):
    jst, jpres, _ = _jax_inputs(*batch)
    jtables, jtv = _jax_tv(jst, jpres, jcfg)
    p8 = j_fused_rates(jst, jpres, jtv, jcfg, DT, True, interpret=True)
    jw = jnp.asarray(w)
    aux = JS.aerosol_lookup_stage(jst, jpres, jw, p8, jtables, jcfg, DT)
    return p8, aux


def test_aerosol_lookup_stage_matches_jax():
    """``xnc_act`` everywhere; ``wev`` where the reference's evaporation
    band holds (outside it the banded gather returns zeros)."""
    cfg, jcfg = MicroConfig(**CFGS["mixed"]), JConfig(**CFGS["mixed"])
    batch, w = _batch(ncol=6, nz=80, seed=7)
    p8, aux = _jax_p8_aux(batch, w, jcfg)
    st, pres, _ = _torch_inputs(*batch)
    tables, _ = _port_tv(st, pres, cfg)
    tp8 = {k: torch.as_tensor(np.array(v)) for k, v in p8.items()}
    got = S.aerosol_lookup_stage(st, pres, torch.as_tensor(w), tp8, tables,
                                 cfg, DT)
    np.testing.assert_allclose(got["xnc_act"].numpy(),
                               np.asarray(aux["xnc_act"]), rtol=1e-12)
    # the reference's evaporation band (solver.aerosol_lookup_stage)
    jst, jpres, _ = _jax_inputs(*batch)
    temp = jst.t + DT * p8["tten"]
    qv = jnp.maximum(1.0e-10, jst.qv + DT * p8["qvten"])
    qvs = JS.rslf(jpres, temp)
    ssatw = qv / qvs - 1.0
    ssatw = jnp.where(jnp.abs(ssatw) < jc.EPS, 0.0, ssatw)
    lvap = jc.LVAP0 + (2106.0 - 4218.0) * (temp - 273.15)
    ocp = 1.0 / (jc.CP * (1.0 + 0.887 * qv))
    lvt2 = lvap * lvap * ocp * jc.ORV / (temp * temp)
    clap = (qv - qvs) / (1.0 + lvt2 * qvs)
    for _ in range(3):
        ex = jnp.exp(jnp.clip(lvt2 * clap, -50.0, 50.0))
        clap = clap - (qvs * ex - qv + clap) / (qvs * lvt2 * ex + 1.0)
    band = np.asarray((clap < -0.5 * jc.EPS) & (ssatw < -0.5e-6)
                      & ((jst.qc + p8["qcten"] * DT) > 0.5 * jc.R1))
    assert band.sum() > 10
    np.testing.assert_allclose(got["wev"].numpy()[band],
                               np.asarray(aux["wev"])[band], rtol=1e-12)


@pytest.mark.parametrize("want_rates", [True, False], ids=["rates", "none"])
def test_fused_post_ref_matches_pallas_interpret(want_rates):
    cfg, jcfg = MicroConfig(**CFGS["mixed"]), JConfig(**CFGS["mixed"])
    batch, w = _batch(ncol=7, nz=32, seed=4)
    p8, aux = _jax_p8_aux(batch, w, jcfg)
    jst, jpres, jdzq = _jax_inputs(*batch)
    st_w, ppt_w, diag_w = j_fused_post(jst, jpres, jdzq, p8, aux, jcfg, DT,
                                       want_rates, interpret=True)
    st, pres, dzq = _torch_inputs(*batch)
    tp8 = {k: torch.as_tensor(np.array(v)) for k, v in p8.items()}
    taux = {k: torch.as_tensor(np.array(v)) for k, v in aux.items()}
    st_g, ppt_g, diag_g = fused_post(st, pres, dzq, tp8, taux, cfg, DT,
                                     want_rates)
    want = {f: np.asarray(getattr(st_w, f)) for f in st_w._fields}
    want.update(_np(diag_w))
    got = {f: getattr(st_g, f).numpy() for f in st_g._fields}
    got.update({k: v.numpy() for k, v in diag_g.items()})
    assert_equiv(got, want)
    for pg, pw in zip(ppt_g, ppt_w):
        np.testing.assert_allclose(pg.numpy(), np.asarray(pw), rtol=1e-8,
                                   atol=1e-20)


def test_column_microphysics_matches_jax_split_path():
    """One whole aerosol step: the port's path (prologue, table stage,
    fused_rates, lookup stage, fused_post) against the JAX split kernels
    in interpret mode, as tests/test_pallas.py runs them."""
    cfg, jcfg = MicroConfig(**CFGS["mixed"]), JConfig(**CFGS["mixed"])
    batch, w = _batch(ncol=7, nz=32, seed=5)
    p8, aux = _jax_p8_aux(batch, w, jcfg)
    jst, jpres, jdzq = _jax_inputs(*batch)
    want_res = j_fused_post(jst, jpres, jdzq, p8, aux, jcfg, DT, True,
                            interpret=True)
    st, pres, dzq = _torch_inputs(*batch)
    tables, _ = _port_tv(st, pres, cfg)
    got_res = S.batched_microphysics(st, pres, torch.as_tensor(w), dzq, DT,
                                     tables, cfg, True, device="cpu")
    want = {f: np.asarray(getattr(want_res[0], f))
            for f in want_res[0]._fields}
    want.update(_np(want_res[2]))
    got = {f: getattr(got_res[0], f).numpy() for f in got_res[0]._fields}
    got.update({k: v.numpy() for k, v in got_res[2].items()})
    assert_equiv(got, want)
    for pg, pw in zip(got_res[1], want_res[1]):
        np.testing.assert_allclose(pg.numpy(), np.asarray(pw), rtol=1e-8,
                                   atol=1e-20)
    assert np.abs(got["nwfa"] - batch[0]["nwfa"]).max() > 0


def test_split_wrappers_reject_bad_inputs():
    cfg = MicroConfig(**CFGS["mixed"])
    st, pres, dzq = _torch_inputs(*_make_batch(ncol=3, nz=8))
    tv = {k: torch.zeros(3, 8, dtype=torch.float32) for k in S.tv_keys(cfg)}
    with pytest.raises(ValueError, match="share one device and dtype"):
        fused_rates(st, pres, tv, cfg, DT, False)
    with pytest.raises(ValueError, match="aero_aux"):
        S.post_from_p8(st, pres, dzq, {}, cfg, DT, False)
    with pytest.raises(ValueError, match="w1d"):
        S.column_microphysics(st, pres, None, dzq, DT, None, cfg)
