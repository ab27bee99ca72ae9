"""The driver step's transport (``driver/advection.py::advect``) on the CPU.

``advect`` is one CUDA kernel on the card (``micro/csrc/advect.cu``) and
its plain version, ``advect_ref``, on the CPU: the step's advection, its
provisional state and the head rows of the microphysics' packed input.
Here:

  * the plain version (the wrapper on the CPU) equals, bit for bit, the
    torch composition the step ran before the kernel (stack, padding,
    tendencies, provisional state, T, pres and dzq as the packs took
    them), in float32 and float64: 1-D warm, mixed and aerosol-aware
    columns with the divergence closure; 2-D on the periodic wrap; and
    a 2-D block whose ghost columns come from a ``Halo`` filled as a
    sharded run fills it, whose rows are those columns of the periodic
    run; the head rows, T and the provisional theta row are compared;
  * the wrapper rejects bad shapes, dtypes, nz above ``MAX_NZ``, a head
    of the wrong size and a destination that is not contiguous;
  * a tensor that is not on the CPU never reaches the plain version (the
    meta device raises), ``advect.launches`` stays 0 on the CPU, and a
    pack whose head rows ``advect`` wrote copies nothing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kid_tpu_torch.dist import mesh as M
from kid_tpu_torch.driver import advection as ADV
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver import loop as L
from kid_tpu_torch.driver.advection import (advective_tendency_x_padded,
                                            advective_tendency_z,
                                            divergence_tendency_z)
from kid_tpu_torch.driver.loop import KidState
from kid_tpu_torch.micro import cuda_build
from kid_tpu_torch.micro import fused_step as F
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro.state import ColumnState
from kid_tpu_torch.tables.cache import get_tables

torch.set_num_threads(2)

# case, columns of the run, the block (lo, hi) of a rank (None: the whole)
CASES = {"warm1": ("warm1", 3, None), "mixed1": ("mixed1", 3, None),
         "aerosol1d": ("aerosol1d", 3, None),
         "cumulus2d": ("cumulus2d", 16, None),
         "cumulus2d_halo": ("cumulus2d", 16, (0, 8))}
DTYPES = {"float32": torch.float32, "float64": torch.float64}
ISTEP = 150


def _state(case, dtype, seed=0):
    """The case's initial sounding with seeded noise on every channel, so
    that every face's limiter and upwind choice vary."""
    rng = np.random.default_rng(seed)
    st = L.initial_state(case, torch.float64, "cpu")
    z = case.grid().z
    out = []
    for f, t in zip(KidState._fields, st):
        layer = 1.0e-4 * (z < 0.5 * case.ztop)[None, :]
        base = t.numpy() + (layer if f in ("qc", "qr", "qi", "qs") else 0.0)
        noise = 1.0 + 0.05 * rng.standard_normal(base.shape)
        out.append(torch.tensor(base * noise, dtype=dtype))
    return KidState(*out)


def _inputs(name, dtype):
    """(case, state, m, Transport, n_adv) of one case of ``CASES``: the
    seeded state of its columns, or of its block's."""
    case_name, nx, block = CASES[name]
    case = dataclasses.replace(tcases.CASES[case_name], nx=nx)
    st = _state(case, dtype)
    m = torch.tensor(case.time_modulation(ISTEP, dtype), dtype=dtype)
    grid = case.grid()

    def prof(a):
        return torch.as_tensor(a, dtype=dtype)

    n_adv = len(L.advected_fields(case.micro))
    lo, hi = block or (0, nx)
    fl = L.build_flow(case, dtype, "cpu", lo, hi)
    ghosts = None
    if block is not None:
        # its left neighbour's right edge and its right neighbour's left
        # edge, as the ring exchange delivers them
        ghosts = M.Halo(case, dtype, "cpu")
        for buf, cols in ((ghosts.left, range(lo - M.HALO, lo)),
                          (ghosts.right, range(hi, hi + M.HALO))):
            idx = torch.tensor(cols) % nx
            buf.copy_(torch.stack([t[idx] for t in st[:n_adv]]))
    tr = ADV.Transport(fl.w_pat, fl.u_pat, prof(grid.rho0), prof(grid.dz),
                       prof(grid.exner)[None, :], fl.pres2, case.u0,
                       case.dx, case.dt, ghosts)
    local = KidState(*[t[lo:hi] for t in st])
    return case, local, m, tr, n_adv


def _composition(case, st, m, tr):
    """The step's torch composition before the kernel (driver/loop.py's
    ``make_step`` and the pack): the head rows the microphysics read, and
    the provisional theta."""
    adv_fields = L.advected_fields(case.micro)
    adv_idx = tuple(KidState._fields.index(f) for f in adv_fields)
    w_face = m * tr.w_pat
    q = torch.stack([st[i] for i in adv_idx])
    ten = advective_tendency_z(q, w_face, tr.rho0, tr.dz)
    if case.is_1d:
        ten = ten + divergence_tendency_z(q, w_face, tr.rho0, tr.dz)
    else:
        u_face = case.u0 * tr.rho0[None, :] + m * tr.u_pat
        if tr.ghosts is None:                 # the periodic wrap, wrap_x
            padded = torch.cat([q[:, -2:], q, q[:, :2]], 1)
        else:                                 # the rank's Halo.pad_x
            padded = torch.cat([tr.ghosts.left, q, tr.ghosts.right], 1)
        ten = ten + advective_tendency_x_padded(padded, u_face, tr.rho0,
                                                case.dx)
    prov = q + ten * case.dt
    prov_named = dict(st._asdict())
    prov_named.update(zip(adv_fields, prov))
    micro_in = ColumnState(
        t=prov_named["theta"] * tr.exner, qv=prov_named["qv"],
        qc=prov_named["qc"], qi=prov_named["qi"], qr=prov_named["qr"],
        qs=prov_named["qs"], qg=prov_named["qg"], ni=prov_named["ni"],
        nr=prov_named["nr"], nc=prov_named["nc"],
        nwfa=prov_named["nwfa"], nifa=prov_named["nifa"])
    shape = st.qv.shape
    head = torch.stack([torch.broadcast_to(t, shape) for t in
                        (*micro_in, tr.pres, tr.dz)])
    return head, prov_named["theta"]


def _equal(got, want, label):
    assert got.dtype == want.dtype, label
    assert torch.equal(got, want), (
        f"{label}: {int((got != want).sum())} cells differ, worst "
        f"{float((got - want).abs().max()):.3e}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_equals_the_composition(name, dtype):
    case, st, m, tr, n_adv = _inputs(name, DTYPES[dtype])
    want, want_theta = _composition(case, st, m, tr)
    for n_head in ADV.HEAD_SIZES:
        out = torch.full((n_head, *st.qv.shape), np.nan, dtype=st.qv.dtype)
        theta = torch.full_like(st.qv, np.nan)
        assert ADV.advect(st, m, tr, n_adv, out, theta) is out
        for row, field in enumerate((*ColumnState._fields, "pres",
                                     "dzq")[:n_head]):
            _equal(out[row], want[row], f"{name} {dtype} {field}")
        _equal(theta, want_theta, f"{name} {dtype} provisional theta")
    # the advection moved something, and theta's row is T, not theta
    assert not torch.equal(out[ADV.HEAD_ROWS[2]], st.qc)
    assert not torch.equal(out[0], theta)
    if CASES[name][2] is not None:
        # the block's rows are those columns of the periodic run
        _, st_all, _, tr_all, _ = _inputs("cumulus2d", DTYPES[dtype])
        all_rows, all_theta = _composition(case, st_all, m, tr_all)
        lo, hi = CASES[name][2]
        _equal(out, all_rows[:, lo:hi], f"{name} {dtype} block rows")
        _equal(theta, all_theta[lo:hi], f"{name} {dtype} block theta")


def test_head_rows_follow_the_field_orders():
    assert ADV.HEAD_ROWS == tuple(
        ColumnState._fields.index("t" if f == "theta" else f)
        for f in KidState._fields)
    assert ADV.N_ADVECTED == tuple(
        len(L.advected_fields(tcases.CASES[n].micro))
        for n in ("warm1", "mixed1", "aerosol1d"))


def _bad(kind, st, m, tr, n_adv):
    """Arguments of ``advect`` spoiled one way."""
    out = torch.empty((14, *st.qv.shape), dtype=st.qv.dtype)
    theta = None
    if kind == "shape":
        st = st._replace(qr=st.qr[:, :-1])
    elif kind == "dtype":
        st = KidState(*[t.to(torch.float16) for t in st])
        out = out.to(torch.float16)
    elif kind == "mixed_dtypes":
        st = st._replace(nc=st.nc.float())
    elif kind == "nz_above_max":
        nz = cuda_build.MAX_NZ + 1
        st = KidState(*[t[:, :1].expand(-1, nz) for t in st])
        tr = tr._replace(w_pat=tr.w_pat[:, :1].expand(-1, nz + 1),
                         rho0=tr.rho0[:1].expand(nz),
                         dz=tr.dz[:1].expand(nz),
                         exner=tr.exner[:, :1].expand(1, nz),
                         pres=tr.pres[:, :1].expand(-1, nz))
        out = torch.empty((14, *st.qv.shape), dtype=st.qv.dtype)
    elif kind == "non_contiguous_out":
        out = torch.empty((14, st.qv.shape[1], st.qv.shape[0]),
                          dtype=st.qv.dtype).transpose(1, 2)
    elif kind == "non_contiguous_theta":
        theta = torch.empty(st.qv.shape[::-1], dtype=st.qv.dtype).T
    elif kind == "head_size":
        out = out[:12]
    elif kind == "n_adv":
        n_adv = 7
    elif kind == "flow_rows":
        tr = tr._replace(w_pat=tr.w_pat[:, :-1])
    return st, m, tr, n_adv, out, theta


@pytest.mark.parametrize("kind", [
    "shape", "dtype", "mixed_dtypes", "nz_above_max", "non_contiguous_out",
    "non_contiguous_theta", "head_size", "n_adv", "flow_rows"])
def test_wrapper_rejects(kind):
    args = _bad(kind, *_inputs("mixed1", torch.float64)[1:])
    with pytest.raises((ValueError, TypeError)):
        ADV.advect(*args)
    ADV.advect(*_bad("none", *_inputs("mixed1", torch.float64)[1:]))


@pytest.mark.parametrize("name", ["mixed1", "cumulus2d_halo"])
def test_wrapper_launches_or_raises_off_the_cpu(name):
    """A tensor that is not on the CPU never reaches the plain version: on
    the meta device the launch raises, as it does for any device but a
    CUDA card's."""
    _, st, m, tr, n_adv = _inputs(name, torch.float32)

    def meta(t):
        return t.to("meta")

    ghosts = tr.ghosts
    if ghosts is not None:
        ghosts = M.Halo(tcases.CUMULUS2D, torch.float32, "meta")
    tr = ADV.Transport(meta(tr.w_pat), meta(tr.u_pat) if tr.u_pat is not None
                       else None, meta(tr.rho0), meta(tr.dz), meta(tr.exner),
                       meta(tr.pres), tr.u0, tr.dx, tr.dt, ghosts)
    out = torch.empty((14, *st.qv.shape), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ADV.advect(KidState(*[meta(t) for t in st]), meta(m), tr, n_adv,
                   out)


def test_launch_count_stays_zero_on_the_cpu():
    cuda_build.reset_launch_counts()
    try:
        _, st, m, tr, n_adv = _inputs("cumulus2d", torch.float64)
        ADV.advect(st, m, tr, n_adv, torch.empty((14, *st.qv.shape),
                                                 dtype=torch.float64))
        case = dataclasses.replace(tcases.MIXED1, nx=2)
        tables = S.device_tables(get_tables(iiwarm=False),
                                 torch.float64, "cpu")
        L.simulate(L.initial_state(case, torch.float64, "cpu"), tables,
                   case, 3, device="cpu")
        counts = cuda_build.launch_counts()
    finally:
        cuda_build.reset_launch_counts()
    assert "advect" in counts
    assert counts == {k: 0 for k in counts}


class Copies(TorchDispatchMode):
    """Counts the ops that copy or stack tensors."""

    NAMES = {"copy_", "stack", "cat", "_to_copy", "clone"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.NAMES:
            self.seen.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_pack_of_the_rows_advect_wrote_copies_nothing():
    case, st, m, tr, n_adv = _inputs("mixed1", torch.float64)
    cfg = case.micro
    ntv = len(S.tv_keys(cfg))
    x = torch.empty((14 + ntv, *st.qv.shape), dtype=torch.float64)
    ADV.advect(st, m, tr, n_adv, x[:14])
    kept = x[:14].clone()
    tv = dict(zip(S.tv_keys(cfg), x[14:]))
    with Copies() as seen:
        got = F.pack_inputs(ColumnState(*x[:12]), x[12], x[13], tv, cfg)
    assert got is x and seen.seen == []
    assert torch.equal(x[:14], kept)
    # a head that is not in place is stacked in, as before
    other = [t.clone() for t in x[:14]]
    with Copies() as seen:
        got = F.pack_inputs(ColumnState(*other[:12]), other[12], other[13],
                            tv, cfg)
    assert got is x and seen.seen == ["stack"]
    assert torch.equal(x[:14], kept)
