"""The table stage (``micro/table_stage.py``) on the CPU.

``table_stage`` is one CUDA kernel on the card (``csrc/table_stage.cu``)
and its plain version, ``solver._table_stage(*solver._prologue(...))``,
on the CPU.  Here:

  * the plain version against the JAX package's ``_table_stage(
    *_prologue(...))`` on seeded columns in float64 (warm, mixed and
    aerosol-aware mixed; a warm and a cold sounding), with the knife-edge
    model of ``tests/test_torch_solver.py::assert_equiv`` at noise 1e-8;
  * the masked gathers: the kernel skips each gather where its
    consumers' mask is off.  The plain version passes each gathered block
    through ``solver.masked_rows(name, mask, rows)``; here that identity
    spoils the rows outside the mask (NaN, or 1e30) and every tv channel
    must keep its bits;
  * the wrapper's contract and the packs that take its rows in place.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from kid_tpu import constants as jc
from kid_tpu.config import MicroConfig as JConfig
from kid_tpu.micro import solver as JS
from kid_tpu.micro.state import ColumnState as JState
from kid_tpu.tables.cache import get_tables as j_get_tables
from kid_tpu_torch.config import MicroConfig
from kid_tpu_torch.convert import state_from_numpy, tables_from_numpy
from kid_tpu_torch.driver.loop import KidState
from kid_tpu_torch.micro import fused_kid_step as FK
from kid_tpu_torch.micro import fused_step as F
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro import split_step as A
from kid_tpu_torch.micro import table_stage as TS
from kid_tpu_torch.micro.state import ColumnState
from test_torch_solver import assert_equiv

torch.set_num_threads(2)

DT = 10.0
CFGS = {"warm": (MicroConfig(iiwarm=True), JConfig(iiwarm=True)),
        "mixed": (MicroConfig(iiwarm=False), JConfig(iiwarm=False)),
        "aerosol": (MicroConfig(iiwarm=False, is_aerosol_aware=True),
                    JConfig(iiwarm=False, is_aerosol_aware=True))}
# each gather's consumers' mask, as csrc/table_stage.cu names it
MASKS = {"racs": "rs_on", "racg": "rg_on", "qrfz": "frz_tab",
         "qcfz": "wfz_tab", "iaus": "ice_on"}
CSRC = Path(S.__file__).parent / "csrc"


def _batch(ncol=12, nz=48, seed=0, cold=False):
    """Seeded columns (``tests/test_torch_solver.py::_make_batch``-style,
    float64 numpy) whose species overlap, so that every gather's mask
    holds at some cells and not at others; ``cold``: 20 K colder."""
    rng = np.random.default_rng(seed)
    zc = (np.arange(nz) + 0.5) * (12000.0 / nz)
    p = 101325.0 * np.exp(-zc / 8500.0)
    t = np.maximum((268.0 if cold else 288.0) - 0.0065 * zc, 200.0)
    qv = 0.012 * np.exp(-zc / 2500.0)
    rho = 0.622 * p / (287.04 * t * (qv + 0.622))

    def b(x, scale=1.0):
        arr = np.broadcast_to(x, (ncol, nz)).copy()
        arr *= np.exp(rng.normal(0.0, 0.5, (ncol, nz)))
        return np.maximum(arr * scale, 0.0)

    def layer(lo, hi, amp):
        return np.where((zc > lo) & (zc < hi), amp, 0.0)

    cloud = layer(500.0, 5000.0, 1.0e-3)
    rain = layer(-1.0, 6000.0, 3.0e-4)
    ice = layer(4000.0, 11000.0, 5.0e-5)
    snow = layer(2500.0, 9000.0, 2.0e-4)
    graupel = layer(2000.0, 7000.0, 1.0e-4)
    state = dict(
        t=t + rng.normal(0.0, 1.0, (ncol, nz)), qv=b(qv), qc=b(cloud),
        qi=b(ice), qr=b(rain), qs=b(snow), qg=b(graupel),
        ni=b(np.where(ice > 0, 1.0e4, 0.0)),
        nr=b(np.where(rain > 0, 1.0e5, 0.0)), nc=b(100.0e6 / rho),
        nwfa=b(300.0e6 / rho), nifa=b(1.0e6 / rho))
    return state, np.broadcast_to(p, (ncol, nz)).copy()


def _port(state, pres, dtype=torch.float64):
    st = state_from_numpy(JState(**state), device="cpu", dtype=dtype)
    return st, torch.as_tensor(pres, dtype=dtype)


def _tables(iiwarm, dtype=torch.float64):
    return tables_from_numpy(j_get_tables(iiwarm=iiwarm), dtype, "cpu")


@pytest.mark.parametrize("cold", [False, True], ids=["warm-sounding",
                                                     "cold-sounding"])
@pytest.mark.parametrize("name", list(CFGS))
def test_table_stage_matches_jax(name, cold):
    cfg, jcfg = CFGS[name]
    state, pres = _batch(seed=3, cold=cold)
    jst = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    jtables = JS.device_tables(j_get_tables(iiwarm=cfg.iiwarm), jnp.float64)
    jpro, jidx = JS._prologue(jst, jnp.asarray(pres), jcfg)
    want = {k: np.asarray(v) for k, v in
            JS._table_stage(jpro, jidx, jtables, jcfg, DT).items()}
    st, tpres = _port(state, pres)
    n0 = TS.table_stage.launches
    got = {k: v.numpy() for k, v in
           TS.table_stage(st, tpres, _tables(cfg.iiwarm), cfg, DT).items()}
    assert TS.table_stage.launches == n0
    assert tuple(got) == S.tv_keys(cfg) and set(want) == set(got)
    if not cfg.iiwarm:
        # the reference looks ef_rw and ef_sw up exactly only inside the
        # bands of levels around their consumers' masks (its
        # _banded_lookup2d; the port reads them at every cell), so they
        # are compared there
        pr = {k: np.asarray(v) for k, v in jpro.items()}
        bands = {"ef_rw": (pr["qr1d"] > 0.5 * jc.R1)
                 & (pr["mvd_r"] > 0.999 * jc.D0R),
                 "ef_sw": (pr["qc1d"] > 0.5 * jc.R1)
                 & (pr["xds"] > 0.999 * jc.D0S)}
        for k, band in bands.items():
            band = band & (pr["mvd_c"] > 0.999 * jc.D0C)
            assert band.any() and not band.all(), k
            got[k] = np.where(band, got[k], 0.0)
            want[k] = np.where(band, want[k], 0.0)
    assert_equiv(got, want)


def _spoiler(seen, fill):
    def masked_rows(name, mask, rows):
        seen.setdefault(name, []).append(torch.broadcast_to(mask, rows.shape))
        return torch.where(mask, rows, torch.full_like(rows, fill))
    return masked_rows


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _spoiled_run(name, cold, dtype, fill, monkeypatch):
    """The plain version with and without spoiled rows outside the masks:
    every tv channel keeps its bits.  Returns the masks each gather saw."""
    cfg, _ = CFGS[name]
    st, pres = _port(*_batch(seed=5, cold=cold), dtype)
    tables = _tables(cfg.iiwarm, dtype)
    want = TS.table_stage_ref(st, pres, tables, cfg, DT)
    seen = {}
    with monkeypatch.context() as m:
        m.setattr(S, "masked_rows", _spoiler(seen, fill))
        got = TS.table_stage_ref(st, pres, tables, cfg, DT)
    assert got.keys() == want.keys() and len(got) == len(S.TV_ICE)
    for k in want:
        assert torch.isfinite(want[k]).all(), k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    return seen


@pytest.mark.parametrize("fill", [float("nan"), 1.0e30], ids=["nan", "big"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name,cold", [("mixed", False), ("mixed", True),
                                       ("aerosol", True)])
def test_skipped_gathers_cannot_change_an_output(name, cold, dtype, fill,
                                                 monkeypatch):
    seen = _spoiled_run(name, cold, dtype, fill, monkeypatch)
    assert set(seen) == set(MASKS)


def test_every_masked_gather_is_exercised_both_ways(monkeypatch):
    """Across the batches each gather's mask holds at some cells and not
    at others, so the spoiled rows are really read or dropped."""
    any_in, any_out = set(), set()
    for cold in (False, True):
        seen = _spoiled_run("mixed", cold, torch.float64, float("nan"),
                            monkeypatch)
        for name, masks in seen.items():
            any_in |= {name} if any(bool(m.any()) for m in masks) else set()
            any_out |= {name} if any(not bool(m.all()) for m in masks) \
                else set()
    assert any_in == any_out == set(MASKS)


def test_kernel_skips_each_gather_under_the_same_mask():
    """``masked_rows("<table>", <mask>, ...)`` in solver.py and ``if
    (<mask>) { ... tb.<table> ...`` in csrc/table_stage.cu, for every
    gather that is masked, with the same mask name on both sides."""
    solver = Path(S.__file__).read_text()
    calls = dict(re.findall(r'masked_rows\(\s*"(\w+)",\s*(\w+)', solver))
    assert calls == MASKS
    cu = (CSRC / "table_stage.cu").read_text()
    for table, mask in MASKS.items():
        assert re.search(rf"if \({mask}\) \{{[^}}]*tb\.{table}\b", cu), table
    # the unmasked reads: ef_rw, ef_sw and tide at every cell
    for table in ("efrw", "efsw"):
        assert f"= tb.{table}[" in cu
    assert "const T tide = tb.iaus[at_i];" in cu


def test_wrapper_runs_the_plain_version_on_the_cpu():
    cfg, _ = CFGS["mixed"]
    st, pres = _port(*_batch(ncol=4, nz=16))
    tables = _tables(False)
    want = TS.table_stage_ref(st, pres, tables, cfg, DT)
    n0 = TS.table_stage.launches
    out = torch.full((len(S.TV_ICE), 4, 16), float("nan"), dtype=st.qv.dtype)
    got = TS.table_stage(st, pres[:1], tables, cfg, DT, out=out)
    assert TS.table_stage.launches == n0
    assert tuple(got) == S.TV_ICE
    for i, (k, v) in enumerate(got.items()):
        assert v.data_ptr() == out[i].data_ptr()
        assert torch.equal(_bits(v), _bits(want[k])), k


def test_wrapper_rejects_bad_inputs():
    cfg, _ = CFGS["mixed"]
    st, pres = _port(*_batch(ncol=3, nz=8))
    tables = _tables(False)
    with pytest.raises(ValueError, match="one device"):
        TS.table_stage(st, pres.to("meta"), tables, cfg, DT)
    with pytest.raises(ValueError, match=r"\(ncol, nz\)"):
        TS.table_stage(ColumnState(*[t[None] for t in st]), pres[None],
                       tables, cfg, DT)
    for bad in (torch.empty(17, 3, 8, dtype=torch.float64),
                torch.empty(18, 3, 8, dtype=torch.float32),
                torch.empty(3, 8, 18, dtype=torch.float64).permute(2, 0, 1)):
        with pytest.raises(ValueError, match="out must be"):
            TS.table_stage(st, pres, tables, cfg, DT, out=bad)
    half = S.DeviceTables(*[t.half() for t in tables])
    with pytest.raises(TypeError, match="float32 or float64"):
        TS.table_stage(ColumnState(*[t.half() for t in st]), pres.half(),
                       half, cfg, DT)


def test_wrapper_launches_or_raises_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version: on
    the meta device the launch raises, as it does for any device but a
    CUDA card's."""
    cfg, _ = CFGS["mixed"]
    st, pres = _port(*_batch(ncol=3, nz=8))
    meta = S.DeviceTables(*[t.to("meta") for t in _tables(False)])
    with pytest.raises(ValueError, match="CUDA tensor"):
        TS.table_stage(ColumnState(*[t.to("meta") for t in st]),
                       pres.to("meta"), meta, cfg, DT)


def _kid_state(st):
    return KidState(theta=st.t, qv=st.qv, qc=st.qc, qr=st.qr, nr=st.nr,
                    qi=st.qi, ni=st.ni, qs=st.qs, qg=st.qg, nc=st.nc,
                    nwfa=st.nwfa, nifa=st.nifa)


PACKS = {
    "fused_step": (F.tv_out, lambda st, p, tv, cfg: F.pack_inputs(
        st, p, p * 0.5, tv, cfg), lambda st, p: [*st, p, p * 0.5]),
    "fused_rates": (A.tv_out, A.pack_rates_inputs, lambda st, p: [*st, p]),
    "fused_kid_step": (
        lambda st, cfg: FK.tv_out(_kid_state(st), cfg),
        lambda st, p, tv, cfg: FK.pack_kid_inputs(
            _kid_state(st), tv, torch.zeros(p.shape[1] + 1, dtype=p.dtype),
            p[0], p[0], p[0], p[0], cfg)[0],
        lambda st, p: list(_kid_state(st)))}


@pytest.mark.parametrize("kernel", list(PACKS))
@pytest.mark.parametrize("name", ["warm", "mixed"])
def test_packs_take_the_table_stage_rows_in_place(kernel, name):
    """The table stage writes into ``tv_out``'s rows; the kernel's pack
    then copies only its head channels into the tensor those rows belong
    to, and equals the stack of every channel."""
    cfg, _ = CFGS[name]
    if kernel == "fused_rates":
        cfg = MicroConfig(iiwarm=cfg.iiwarm, is_aerosol_aware=True)
    tv_out, pack, head = PACKS[kernel]
    st, pres = _port(*_batch(ncol=5, nz=12))
    pres = pres[:1].expand_as(st.qv)
    tables = _tables(cfg.iiwarm)
    out = tv_out(st, cfg)
    tv = TS.table_stage(st, pres, tables, cfg, DT, out=out)
    x = pack(st, pres, tv, cfg)
    assert x.data_ptr() == out._base.data_ptr() and x.is_contiguous()
    want = torch.stack([torch.broadcast_to(t, st.qv.shape) for t in
                        head(st, pres) + list(tv.values())])
    assert torch.equal(x, want)
    # a tv dict of other tensors is stacked into a new one
    fresh = {k: v.clone() for k, v in tv.items()}
    y = pack(st, pres, fresh, cfg)
    assert y.data_ptr() != x.data_ptr() and torch.equal(y, want)


@pytest.mark.parametrize("name", list(CFGS))
def test_solver_step_equals_the_plain_composition(name):
    """``batched_microphysics`` on the CPU (the table stage's rows in the
    next kernel's packed input) gives the bits of the plain stages
    composed by hand."""
    cfg, _ = CFGS[name]
    st, pres = _port(*_batch(ncol=4, nz=24, seed=7))
    dzq = torch.full_like(st.qv, 250.0)
    w = torch.full_like(st.qv, 1.0)
    tables = _tables(cfg.iiwarm)
    got = S.batched_microphysics(st, pres, w, dzq, DT, tables, cfg, True,
                                 device="cpu")
    tv = S._table_stage(*S._prologue(st, pres, cfg), tables, cfg, DT)
    if cfg.is_aerosol_aware:
        p8 = A.fused_rates_ref(st, pres, tv, cfg, DT, True)
        aux = S.aerosol_lookup_stage(st, pres, w, p8, tables, cfg, DT)
        want = A.fused_post_ref(st, pres, dzq, p8, aux, cfg, DT, True)
    else:
        want = F.fused_step_ref(st, pres, dzq, tv, cfg, DT, True)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(_bits(a), _bits(b))


def _leaves(res):
    """The state, precip and rate profiles of a step, in one order."""
    st, ppt, diag = res
    return [*st, *ppt, *[diag[k] for k in sorted(diag)]]
