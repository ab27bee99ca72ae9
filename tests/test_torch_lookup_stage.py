"""The aerosol-aware step's lookup stage (``split_step.lookup_stage``) on
the CPU.

``lookup_stage`` is one CUDA kernel on the card (``csrc/lookup_stage.cu``)
and its plain version, ``solver.aerosol_lookup_stage``, on the CPU; the
card holds the two against each other in ``chip_smoke.py`` phase 2g.  Here:

  * the wrapper's CPU path is the plain version bit for bit, written into
    the rows it is given;
  * ``fused_rates`` and the lookups write into the last 17 rows of
    ``fused_post``'s packed input (``post_out``), whose pack then copies
    only the 14 head rows and equals the stack of all 31;
  * an aerosol-aware ``column_microphysics`` step gives the bits of the
    plain stages composed as the step composed them before, with and
    without the driver's packed input, with and without rate profiles;
  * the wrapper's contract, and the kernel's channel order and constants.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kid_tpu_torch.config import MicroConfig
from kid_tpu_torch.driver.cases import AEROSOL1D
from kid_tpu_torch.driver.loop import run_case
from kid_tpu_torch.micro import cuda_build
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro import split_step as A
from kid_tpu_torch.micro import table_stage as TS
from kid_tpu_torch.micro.aerosol import _LOG_TA_NA, _LOG_TA_WW
from kid_tpu_torch.micro.state import ColumnState
from kid_tpu_torch.tables.cache import get_tables

torch.set_num_threads(2)

DT = 10.0
CFGS = {"mixed": MicroConfig(iiwarm=False, is_aerosol_aware=True),
        "warm": MicroConfig(iiwarm=True, is_aerosol_aware=True)}
DTYPES = {"f64": torch.float64, "f32": torch.float32}
CU = Path(S.__file__).parent / "csrc" / "lookup_stage.cu"


def _bits(x):
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def _batch(ncol=6, nz=24, seed=0, dtype=torch.float64, cold=False):
    """Seeded aerosol-aware columns whose cloud comes and goes, so that
    both sides of every index's clip and of ``l_qc`` occur; ``cold``: 40 K
    colder, ice-supersaturated above (DeMott and Koop nucleation).
    Returns (state, pres, w, dzq)."""
    rng = np.random.default_rng(seed)
    zc = (np.arange(nz) + 0.5) * (12000.0 / nz)
    p = 101325.0 * np.exp(-zc / 8500.0)
    t = np.maximum((248.0 if cold else 288.0) - 0.0065 * zc, 200.0)
    qv = 0.012 * np.exp(-zc / 2500.0) * (0.2 if cold else 1.0)
    rho = 0.622 * p / (287.04 * t * (qv + 0.622))

    def b(x):
        arr = np.broadcast_to(x, (ncol, nz)) * np.exp(
            rng.normal(0.0, 0.7, (ncol, nz)))
        return torch.tensor(np.maximum(arr, 0.0), dtype=dtype)

    def layer(lo, hi, amp):
        return np.where((zc > lo) & (zc < hi), amp, 0.0)

    st = ColumnState(
        t=torch.tensor(t + rng.normal(0.0, 1.0, (ncol, nz)), dtype=dtype),
        qv=b(qv), qc=b(layer(300.0, 5000.0, 1.0e-3)),
        qi=b(layer(4000.0, 11000.0, 5.0e-5)), qr=b(layer(-1.0, 6000.0, 3e-4)),
        qs=b(layer(2500.0, 9000.0, 2.0e-4)), qg=b(layer(2000.0, 7000.0, 1e-4)),
        ni=b(layer(4000.0, 11000.0, 1.0e4)), nr=b(layer(-1.0, 6000.0, 1e5)),
        nc=b(100.0e6 / rho), nwfa=b(300.0e6 / rho), nifa=b(1.0e6 / rho))
    pres = torch.tensor(np.broadcast_to(p, (ncol, nz)).copy(), dtype=dtype)
    w = torch.tensor(rng.uniform(-1.0, 40.0, (ncol, nz)), dtype=dtype)
    dzq = torch.full((ncol, nz), 12000.0 / nz, dtype=dtype)
    return st, pres, w, dzq


def _tables(cfg, dtype):
    return S.device_tables(get_tables(iiwarm=cfg.iiwarm), dtype, "cpu")


def _p8(st, pres, cfg, tables, want_rates=False):
    tv = S._table_stage(*S._prologue(st, pres, cfg), tables, cfg, DT)
    return A.fused_rates_ref(st, pres, tv, cfg, DT, want_rates)


@pytest.mark.parametrize("cold", [False, True], ids=["warm-sounding",
                                                     "cold-sounding"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrapper_is_the_plain_stage_written_into_its_rows(dtype, cold):
    cfg = CFGS["mixed"]
    st, pres, w, _ = _batch(dtype=DTYPES[dtype], cold=cold)
    tables = _tables(cfg, DTYPES[dtype])
    p8 = _p8(st, pres, cfg, tables)
    want = S.aerosol_lookup_stage(st, pres, w, p8, tables, cfg, DT)
    n0 = A.lookup_stage.launches
    fresh = A.lookup_stage(st, pres, w, p8, tables, cfg, DT)
    out = torch.full((2, *st.qv.shape), float("nan"), dtype=st.qv.dtype)
    got = A.lookup_stage(st, pres[:1], w, p8, tables, cfg, DT, out=out)
    assert A.lookup_stage.launches == n0      # the CPU launches nothing
    assert tuple(got) == A.AUX_KEYS
    for i, k in enumerate(A.AUX_KEYS):
        assert got[k].data_ptr() == out[i].data_ptr()
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
        assert torch.equal(_bits(fresh[k]), _bits(want[k])), k
    # the batch reaches more than one bin of each axis the kernel reads
    assert len(torch.unique(want["wev"])) > 3
    assert len(torch.unique(want["xnc_act"])) > 10


def _count_copied(fn):
    """``fn()`` and the elements that stack, cat and copy_ wrote in it."""
    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in ("stack", "cat", "copy_"):
                Count.n += out.numel()
            return out

    with Count():
        res = fn()
    return res, Count.n


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_post_pack_copies_only_its_head_into_the_rows_in_place(dtype):
    cfg = CFGS["mixed"]
    st, pres, w, dzq = _batch(dtype=DTYPES[dtype])
    tables = _tables(cfg, DTYPES[dtype])
    tv = S._table_stage(*S._prologue(st, pres, cfg), tables, cfg, DT)
    post = A.post_out(st)
    assert post.shape == (17, *st.qv.shape) and post._base.shape[0] == 31
    p8 = A.fused_rates(st, pres, tv, cfg, DT, False, out=post[:15])
    aux = A.lookup_stage(st, pres, w, p8, tables, cfg, DT, out=post[15:])
    p8_ref = A.fused_rates_ref(st, pres, tv, cfg, DT, False)
    aux_ref = S.aerosol_lookup_stage(st, pres, w, p8_ref, tables, cfg, DT)
    x, n = _count_copied(lambda: A.pack_post_inputs(st, pres, dzq, p8, aux))
    assert x.data_ptr() == post._base.data_ptr() and x.is_contiguous()
    assert n == 14 * st.qv.numel()
    want = torch.stack([*st, pres, dzq] + [p8_ref[k] for k in S.P8_OUT]
                       + [aux_ref[k] for k in A.AUX_KEYS])
    assert torch.equal(_bits(x), _bits(want))
    # other tensors are stacked into a new one, all 31 rows
    y, n = _count_copied(lambda: A.pack_post_inputs(
        st, pres, dzq, {k: v.clone() for k, v in p8.items()}, aux))
    assert y.data_ptr() != x.data_ptr() and n == 31 * st.qv.numel()
    assert torch.equal(_bits(y), _bits(want))


def _before(st, pres, w, dzq, tables, cfg, want_rates, dt=DT):
    """The step as the plain stages composed it before the lookup kernel:
    the table stage into the rows of ``fused_rates``' input, then
    ``fused_rates``, ``aerosol_lookup_stage`` and ``fused_post``, each
    into tensors of its own."""
    tv = TS.table_stage(st, pres, tables, cfg, dt, out=A.tv_out(st, cfg))
    p8 = A.fused_rates_ref(st, pres, tv, cfg, dt, want_rates)
    aux = S.aerosol_lookup_stage(st, pres, w, p8, tables, cfg, dt)
    return A.fused_post_ref(st, pres, dzq, p8, aux, cfg, dt, want_rates)


def _leaves(res):
    st, ppt, diag = res
    return [*st, *ppt, *[diag[k] for k in sorted(diag)]]


@pytest.mark.parametrize("packed", [False, True], ids=["alone", "packed"])
@pytest.mark.parametrize("want_rates", [False, True], ids=["no_rates",
                                                           "rates"])
@pytest.mark.parametrize("name", list(CFGS))
def test_column_step_keeps_its_bits(name, want_rates, packed):
    cfg = CFGS[name]
    st, pres, w, dzq = _batch(seed=3)
    tables = _tables(cfg, torch.float64)
    want = _before(st, pres, w, dzq, tables, cfg, want_rates)
    x = None
    if packed:     # the driver's buffer: the state and pres, then the tail
        x = torch.empty((13 + len(S.tv_keys(cfg)), *st.qv.shape),
                        dtype=st.qv.dtype)
        x[:12] = torch.stack(list(st))
        x[12] = pres
        st, pres = ColumnState(*x[:12]), x[12]
    got = S.column_microphysics(st, pres, w, dzq, DT, tables, cfg,
                                want_rates, packed=x)
    assert sorted(got[2]) == sorted(want[2])
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("n_steps", [0, 200])
def test_aerosol1d_states_keep_their_bits(n_steps):
    """On aerosol1d's own states (a column after 0 and 200 steps),
    float32: the step without rate profiles, as the loop takes it."""
    case = dataclasses.replace(AEROSOL1D, nx=1)
    cfg, dtype = case.micro, torch.float32
    st, _ = run_case(case, dtype, n_steps=n_steps, device="cpu")
    tables = _tables(cfg, dtype)
    grid = case.grid()
    mst = ColumnState(t=st.theta * torch.as_tensor(grid.exner, dtype=dtype),
                      **{f: getattr(st, f) for f in ColumnState._fields
                         if f != "t"})
    pres = torch.broadcast_to(torch.as_tensor(grid.pres, dtype=dtype),
                              mst.qv.shape)
    w = torch.full_like(mst.qv, 1.5)
    dzq = torch.broadcast_to(torch.as_tensor(grid.dz, dtype=dtype),
                             mst.qv.shape)
    want = _before(mst, pres, w, dzq, tables, cfg, False, case.dt)
    got = S.column_microphysics(mst, pres, w, dzq, case.dt, tables, cfg,
                                False)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(_bits(a), _bits(b))


def test_wrapper_rejects_bad_inputs():
    cfg = CFGS["mixed"]
    st, pres, w, _ = _batch(ncol=3, nz=8)
    tables = _tables(cfg, torch.float64)
    p8 = _p8(st, pres, cfg, tables)
    with pytest.raises(ValueError, match="one device"):
        A.lookup_stage(st, pres, w.to("meta"), p8, tables, cfg, DT)
    for bad in (torch.empty(3, 3, 8, dtype=torch.float64),
                torch.empty(2, 3, 8, dtype=torch.float32),
                torch.empty(3, 8, 2, dtype=torch.float64).permute(2, 0, 1)):
        with pytest.raises(ValueError, match="out must be"):
            A.lookup_stage(st, pres, w, p8, tables, cfg, DT, out=bad)
    tv = S._table_stage(*S._prologue(st, pres, cfg), tables, cfg, DT)
    with pytest.raises(ValueError, match="out must be"):
        A.fused_rates(st, pres, tv, cfg, DT, True,
                      out=torch.empty(15, 3, 8, dtype=torch.float64))


def test_wrapper_launches_or_raises_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version: on
    the meta device the launch raises, as it does for any device but a
    CUDA card's; the launch itself refuses CPU tensors."""
    cfg = CFGS["mixed"]
    st, pres, w, _ = _batch(ncol=3, nz=8)
    tables = _tables(cfg, torch.float64)
    p8 = _p8(st, pres, cfg, tables)
    meta = S.DeviceTables(*[t.to("meta") for t in tables])

    def on_meta(t):
        return t.to("meta")

    with pytest.raises(ValueError, match="CUDA tensor"):
        A.lookup_stage(ColumnState(*map(on_meta, st)), on_meta(pres),
                       on_meta(w), {k: on_meta(v) for k, v in p8.items()},
                       meta, cfg, DT)
    chans = [torch.zeros(3, 8, dtype=torch.float64)] * 12
    with pytest.raises(ValueError, match="CUDA tensor"):
        A.launch_lookup(chans, tables, torch.zeros(2, 3, 8,
                                                   dtype=torch.float64),
                        cfg, DT)


@pytest.mark.parametrize("name", ["fused_rates", "lookup_stage",
                                  "fused_post"])
def test_plain_versions_take_their_wrappers_arguments(name):
    """A plain path swaps each wrapper for its plain version (as
    ``chip_smoke.py`` phase 4 does on the card), so the two take the same
    arguments."""
    import inspect
    assert inspect.signature(getattr(A, name)).parameters.keys() == \
        inspect.signature(getattr(A, f"{name}_ref")).parameters.keys()


def test_kernel_reads_the_channels_and_constants_the_wrapper_passes():
    cu = CU.read_text()
    enum = re.search(r"enum LookupCh \{([^}]*)\}", cu).group(1)
    names = [e.strip()[2:] for e in enum.replace("\n", " ").split(",")][:-1]
    assert tuple(names) == A.LOOKUP_CHANNELS
    assert "kNIn" in enum and len(A.LOOKUP_CHANNELS) == 12
    # the axes' lengths and the tables' shapes
    from kid_tpu_torch import constants as c
    assert re.search(r"kNa = (\d+), kNw = (\d+), kNt = (\d+)", cu).groups() \
        == (str(len(c.TA_NA)), str(len(c.TA_WW)), str(len(c.TA_TK)))
    tables = _tables(CFGS["mixed"], torch.float32)
    for k, shape in A.LOOKUP_TABLES.items():
        assert tuple(getattr(tables, k).shape) == shape
    # the log axes and the first drop-number bin, as the plain stage's
    header = cuda_build.constants_header()
    for name, vals in (("LOG_TA_NA", _LOG_TA_NA), ("LOG_TA_WW", _LOG_TA_WW),
                       ("TNC1", [c.T_NC[0]])):
        for i, v in enumerate(vals):
            key = name if name == "TNC1" else f"{name}_{i}"
            assert f"constexpr double {key} = {float(v).hex()};" in header
    assert "lookup_stage" in cuda_build.wrappers()
