"""The port's compiled time loop on the CPU: the device-indexed step that a
CUDA graph captures, its chunks, its cache and the capture's rules.

``simulate`` reads m(t) from a device table at a device counter and writes
the streams into chunk buffers (``driver/loop.py::StepLoop``).  Here:

  * it equals, bit for bit, a plain per-step loop that takes m(t) from
    ``time_modulation`` as a host float and writes the streams at a host
    index, for mixed1, aerosol1d, the fused driver, warm1_recon and
    cumulus2d, across chunk boundaries from a non-zero ``istep0``; two
    chunked calls equal one call; the m table is ``time_modulation``;
  * one step of each path, with the kernel wrappers replaced by
    shape-correct stubs on the meta device, makes no host sync and no
    copy between host and device (the part of a capture that can be
    checked without a card), after the warm-up step the loop runs before
    capturing; so does a sharded rank's step, whose ghost columns come
    from its ``Halo``, filled outside the step or by the step itself
    (``Halo.swap``, its P2P stubbed by a local wrap);
  * the cache of column blocks, with a stand-in capture that replays
    eagerly: a block's capture keys on dtype, tables, profile names and
    the fused switch and is reused otherwise; the cache is bounded; a
    replay adds the captured launches; the caller gets tensors of its own;
    a failed capture raises; a second call builds no flow pattern; the
    eager loop copies no state back; the sharded path asks for the graphed
    loop and runs eagerly on the CPU; aerosol1d's steps, graphed and eager,
    count each split kernel once a step;
  * the sharded loop on one rank: the split halo exchange runs once a
    step and never inside the step, the in-step one once a step and only
    inside it, no host exchange between two replays, graphed and eager,
    one exchange and one ``fused_step`` counted a replay, and the result
    is ``simulate``'s; a second call on the same block captures nothing
    new; the placement follows the group's backend and the device.
"""
from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kid_tpu_torch.dist import mesh as M
from kid_tpu_torch.driver import advection as ADV
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver import loop as L
from kid_tpu_torch.driver.loop import KidState
from kid_tpu_torch.micro import cuda_build
from kid_tpu_torch.micro import fused_kid_step as FK
from kid_tpu_torch.micro import fused_step as F
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro import split_step as A
from kid_tpu_torch.micro import table_stage as TS
from kid_tpu_torch.micro.state import Precip
from kid_tpu_torch.tables.cache import get_tables

torch.set_num_threads(2)

PPT = ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice")
NAMES = ("qr", "nwfa", "prr_wau", "dqv_mphys")
# the loop's paths: (case, columns, fused driver); 2-D at 16 columns
PATHS = {"mixed1": ("mixed1", 2, False),
         "aerosol1d": ("aerosol1d", 2, False),
         "fused": ("mixed1", 2, True),
         "warm1_recon": ("warm1_recon", 2, False),
         "cumulus2d": ("cumulus2d", 16, False)}
N_STEPS, ISTEP0 = L.CHUNK_STEPS + 3, 150       # crosses a chunk boundary


@pytest.fixture(autouse=True)
def _fresh_caches():
    L.BLOCKS.clear()
    yield
    L.BLOCKS.clear()


def _tables(case, dtype=torch.float64):
    return S.device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype,
                           "cpu")


def _seeded(case, dtype=torch.float64, seed=0):
    """The case's initial sounding with seeded cloud and rain layers."""
    rng = np.random.default_rng(seed)
    st = L.initial_state(case, dtype, "cpu")._asdict()
    z = case.grid().z
    layers = [("qc", 5.0e-4), ("qr", 2.0e-4)]
    if not case.micro.iiwarm:
        layers.append(("qs", 1.0e-4))
    for f, amp in layers:
        prof = np.where(z < 0.4 * case.ztop, amp, 0.0)
        st[f] = torch.tensor(prof[None, :] * rng.random((case.nx, 1)),
                             dtype=dtype)
    st["nr"] = (st["qr"] > 0).to(dtype) * 1.0e5
    return KidState(**st)


def _path(name, monkeypatch):
    case_name, nx, fused = PATHS[name]
    if fused:
        monkeypatch.setenv(L.FUSED_DRIVER_ENV, "1")
    return dataclasses.replace(tcases.CASES[case_name], nx=nx)


def _per_step_loop(st, tables, case, n_steps, names, istep0):
    """A plain loop over steps: m(t) from ``time_modulation`` as a host
    float (a 0-d tensor for the fused kernel, whose interface takes one),
    the flow patterns built here, each stream written at a host index."""
    dtype, grid = st.qv.dtype, case.grid()

    def put(a):
        return torch.tensor(np.asarray(a), dtype=dtype)

    u_pat = None if case.is_1d else put(case.rhou_pattern(grid))
    step = L.make_step(case, tables, dtype, "cpu",
                       put(case.rhow_pattern(grid)), u_pat,
                       torch.broadcast_to(put(grid.pres), st.qv.shape),
                       None, names)
    fused = os.environ.get(L.FUSED_DRIVER_ENV) == "1"
    ppt = torch.empty((n_steps, 4, case.nx), dtype=dtype)
    profiles = {n: torch.empty((n_steps,) + st.qv.shape, dtype=dtype)
                for n in names}
    for i in range(n_steps):
        m = case.time_modulation(istep0 + i, dtype)
        st, p, profs = step(st, torch.tensor(m, dtype=dtype) if fused else m)
        ppt[i] = p
        for n, v in profs.items():
            profiles[n][i] = v
    return st, ppt, profiles


def _assert_same(got, want_state, want_ppt, want_profiles):
    st, out = got
    for f in KidState._fields:
        assert torch.equal(getattr(st, f), getattr(want_state, f)), f
    for i, k in enumerate(PPT):
        assert torch.equal(getattr(out, k), want_ppt[:, i]), k
    assert set(out.profiles) == set(want_profiles)
    for k, v in want_profiles.items():
        assert torch.equal(out.profiles[k], v), k


@pytest.mark.parametrize("name", list(PATHS))
def test_loop_equals_per_step_loop_bit_for_bit(name, monkeypatch):
    case = _path(name, monkeypatch)
    calls = []
    kernel = FK.fused_kid_step
    monkeypatch.setattr(FK, "fused_kid_step",
                        lambda *a: calls.append(1) or kernel(*a))
    tables, st0 = _tables(case), _seeded(case)
    got = L.simulate(st0, tables, case, N_STEPS, NAMES, ISTEP0, device="cpu")
    want = _per_step_loop(st0, tables, case, N_STEPS, NAMES, ISTEP0)
    assert len(calls) == (2 * N_STEPS if PATHS[name][2] else 0)
    _assert_same(got, *want)
    assert float(got[1].ppt_rain.abs().sum()) > 0.0


def test_two_chunked_calls_equal_one_call():
    case = dataclasses.replace(tcases.MIXED1, nx=2)
    tables, st0 = _tables(case), _seeded(case)
    n1, n2 = 7, L.CHUNK_STEPS + 2
    st1, out1 = L.simulate(st0, tables, case, n1, NAMES, ISTEP0,
                           device="cpu")
    st2, out2 = L.simulate(st1, tables, case, n2, NAMES, ISTEP0 + n1,
                           device="cpu")
    want = L.simulate(st0, tables, case, n1 + n2, NAMES, ISTEP0,
                      device="cpu")
    cat = torch.cat([torch.stack([getattr(o, k) for k in PPT], 1)
                     for o in (out1, out2)])
    _assert_same((st2, want[1]), want[0], cat, {
        k: torch.cat([out1.profiles[k], out2.profiles[k]]) for k in NAMES})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["mixed1", "warm1", "cumulus2d",
                                  "orographic2d"])
def test_modulation_table_is_time_modulation(name, dtype):
    case = tcases.CASES[name]
    table = case.modulation_table(0, case.n_steps, dtype)
    assert table.dtype == (np.float32 if dtype == torch.float32
                           else np.float64)
    want = [case.time_modulation(i, dtype) for i in range(case.n_steps)]
    np.testing.assert_array_equal(table.astype(np.float64), want)
    part = case.modulation_table(37, 5, dtype)
    np.testing.assert_array_equal(part, table[37:42])


# ---- capture safety: no host sync inside the step ------------------------

class NoHostSync(TorchDispatchMode):
    """Raises on an op that reads a device tensor's value on the host or
    copies between the host and a device: what a CUDA graph cannot
    capture.  Ops on host (CPU) tensors alone are host work and pass."""

    SYNCS = {"_local_scalar_dense", "nonzero", "masked_select", "item"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        tensors = [a for a in (*args, *kwargs.values())
                   if isinstance(a, torch.Tensor)]
        if name in self.SYNCS and any(t.device.type != "cpu"
                                      for t in tensors):
            raise AssertionError(f"host sync: {func}")
        if name in ("index", "index_put") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):                # a mask: nonzero inside
            raise AssertionError(f"host sync: {func} with a mask")
        if name in ("_to_copy", "copy_"):
            devs = {t.device.type for t in tensors}
            if "device" in kwargs and kwargs["device"] is not None:
                devs.add(torch.device(kwargs["device"]).type)
            if len(devs) > 1:
                raise AssertionError(f"host-device copy: {func} {devs}")
        return func(*args, **kwargs)


def _stub_state(cls, like, n=12):
    return cls(*[torch.empty_like(like) for _ in range(n)])


def _stub_precip(like):
    return Precip(*[torch.empty_like(like[:, 0]) for _ in range(4)])


def _stub_kernels(monkeypatch, calls):
    """Shape-correct stand-ins for the seven kernel wrappers."""
    def advect(st, m, tr, n_adv, out, theta_out=None):
        calls.append("advect")
        assert m.dim() == 0 and m.device == st[0].device == out.device
        assert out.shape == (out.shape[0], *st[0].shape)
        return out

    def table_stage(state, pres, tables, cfg, dt_f, out=None):
        calls.append("table_stage")
        keys = S.tv_keys(cfg)
        if out is None:
            out = torch.empty((len(keys), *state.qv.shape),
                              dtype=state.qv.dtype, device=state.qv.device)
        assert out.shape == (len(keys), *state.qv.shape)
        assert out.device == state.qv.device == pres.device
        return dict(zip(keys, out))

    def fused_step(state, pres, dzq, tv, cfg, dt_f, want_rates):
        calls.append("fused_step")
        diag = ({k: torch.empty_like(state.qv) for k in S.DIAG_KEYS}
                if want_rates else {})
        return (_stub_state(type(state), state.qv), _stub_precip(state.qv),
                diag)

    def fused_rates(state, pres, tv, cfg, dt_f, want_rates, out=None):
        calls.append("fused_rates")
        keys = S.P8_OUT + (S.P8_RATES if want_rates else ())
        if out is None:
            return {k: torch.empty_like(state.qv) for k in keys}
        assert out.shape == (len(keys), *state.qv.shape)
        return dict(zip(keys, out))

    def lookup_stage(state, pres, w1d, p8, tables, cfg, dt_f, out=None):
        calls.append("lookup_stage")
        if out is None:
            out = torch.empty((2, *state.qv.shape), dtype=state.qv.dtype,
                              device=state.qv.device)
        assert out.shape == (2, *state.qv.shape)
        assert w1d.device == out.device == p8["tten"].device
        return dict(zip(A.AUX_KEYS, out))

    def fused_post(state, pres, dzq, p8, aux, cfg, dt_f, want_rates):
        calls.append("fused_post")
        # without rate profiles p8 and aux are the last rows of one buffer
        base = aux["wev"]._base
        assert want_rates or (base is not None and base is p8["tten"]._base
                              and base.shape[0] == 31)
        diag = {}
        if want_rates:
            diag = {k: p8[k] for k in S.P8_RATES}
            diag.update({k: torch.empty_like(state.qv)
                         for k in ("prr_gml", "prv_rev", "pnr_rev")})
        return (_stub_state(type(state), state.qv), _stub_precip(state.qv),
                diag)

    def fused_kid_step(st, w_pat_prof, mmod, tv, *rest):
        calls.append("fused_kid_step")
        assert mmod.dim() == 0 and mmod.device == st.qv.device
        diag = ({k: torch.empty_like(st.qv) for k in S.DIAG_KEYS}
                if rest[-1] else {})
        return _stub_state(KidState, st.qv), _stub_precip(st.qv), diag

    monkeypatch.setattr(ADV, "advect", advect)
    monkeypatch.setattr(TS, "table_stage", table_stage)
    monkeypatch.setattr(F, "fused_step", fused_step)
    monkeypatch.setattr(A, "fused_rates", fused_rates)
    monkeypatch.setattr(A, "lookup_stage", lookup_stage)
    monkeypatch.setattr(A, "fused_post", fused_post)
    monkeypatch.setattr(FK, "fused_kid_step", fused_kid_step)


@pytest.mark.parametrize("name", list(PATHS) + ["sharded",
                                                "sharded_in_step",
                                                "aerosol1d_no_rates"])
def test_step_makes_no_host_sync(name, monkeypatch):
    # "sharded": rank 0's block of cumulus2d on 2 ranks, its ghost columns
    # read from a Halo; "sharded_in_step": the same, the step filling them
    # first (Halo.swap), its sends and receives stubbed by a local wrap;
    # "aerosol1d_no_rates": no rate profile, so the split kernels write
    # into fused_post's packed input
    sharded = name.startswith("sharded")
    no_rates = name == "aerosol1d_no_rates"
    case = _path("cumulus2d" if sharded else
                 "aerosol1d" if no_rates else name, monkeypatch)
    calls = []
    _stub_kernels(monkeypatch, calls)
    dev, dtype = torch.device("meta"), torch.float32
    tables = S.DeviceTables(*[t.to(dev) for t in _tables(case, dtype)])
    names = tuple(n for n in L.ALL_PROFILE_NAMES
                  if not (no_rates and n in L.RATE_NAMES))
    lo, hi = M.column_block(case.nx, 0, 2) if sharded else (0, case.nx)
    halo = M.Halo(case, dtype, dev)
    ghosts = halo if sharded else None
    exchange = None
    if name == "sharded_in_step":
        _world(monkeypatch, 2, 0)
        monkeypatch.setattr(M, "_ring", lambda send, recv, group:
                            calls.append("ring") or recv.copy_(send))
        exchange = M.StepExchange(halo, None)
    fl = L.build_flow(case, dtype, dev, lo, hi)
    step = L.make_step(case, tables, dtype, dev, fl.w_pat, fl.u_pat,
                       fl.pres2, ghosts, names)
    shape = (hi - lo, case.nz)
    loop = L.StepLoop(step, shape, dtype, dev, names, exchange)
    loop.state = KidState(*[t[lo:hi]
                            for t in L.initial_state(case, dtype, dev)])
    loop.start_chunk(case.modulation_table(ISTEP0, L.CHUNK_STEPS, dtype))
    loop.advance()                # the warm-up step, as before a capture
    n_warm = len(calls)
    with NoHostSync():
        loop.step_in_place()      # what the capture records
    want = {"mixed1": ["advect", "table_stage", "fused_step"],
            "warm1_recon": ["advect", "table_stage", "fused_step"],
            "cumulus2d": ["advect", "table_stage", "fused_step"],
            "fused": ["advect", "table_stage", "fused_kid_step"],
            "aerosol1d": ["advect", "table_stage", "fused_rates",
                          "lookup_stage", "fused_post"],
            "sharded": ["advect", "table_stage", "fused_step"],
            "sharded_in_step": ["ring", "advect", "table_stage",
                                "fused_step"]}[
        "aerosol1d" if no_rates else name]
    assert calls[n_warm:] == want
    assert loop.profiles["qr" if no_rates else "prr_wau"].shape == (
        L.CHUNK_STEPS,) + shape


@pytest.mark.parametrize("op", ["item", "float", "nonzero", "mask_index",
                                "to_host", "from_host"])
def test_no_host_sync_mode_catches(op):
    x = torch.ones(3, 2, device="meta")
    ops = {"item": lambda: x.sum().item(), "float": lambda: float(x[0, 0]),
           "nonzero": lambda: torch.nonzero(x),
           "mask_index": lambda: x[x > 0], "to_host": lambda: x.cpu(),
           "from_host": lambda: torch.as_tensor(np.ones(2), device="meta")}
    with pytest.raises(AssertionError, match="host"):
        with NoHostSync():
            ops[op]()


# ---- the capture cache, with a capture that replays eagerly ---------------

class EagerCapture(L.CapturedStep):
    """Stands in for a CUDA graph's capture on the CPU: warm-up as the real
    one, then a "graph" whose replay runs the step eagerly and counts one
    ``fused_step`` launch."""

    built = []

    def __init__(self, loop, state0, key, tables):
        EagerCapture.built.append(tables)
        self.loop, self.key, self.tables = loop, key, tables
        loop.state = KidState(*[t.clone() for t in state0])
        cuda_build.take_launches(loop.advance)
        self.graph = SimpleNamespace(replay=loop.step_in_place)
        self.launches = {"fused_step": 1}


@pytest.fixture
def eager_graphs(monkeypatch):
    """``simulate`` takes its graphed path on the CPU, through
    ``EagerCapture``."""
    EagerCapture.built = []
    monkeypatch.setattr(L, "GRAPH_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(L, "CapturedStep", EagerCapture)
    return EagerCapture.built


def _small(name="mixed1"):
    case = dataclasses.replace(tcases.CASES[name], nx=2)
    return case, _tables(case), _seeded(case)


def test_graphed_path_equals_eager_and_counts_replays(eager_graphs):
    case, tables, st0 = _small()
    eager = L.simulate(st0, tables, case, N_STEPS, NAMES, ISTEP0,
                       device="cpu", graphs=False)
    assert not eager_graphs
    cuda_build.reset_launch_counts()
    try:
        got = L.simulate(st0, tables, case, N_STEPS, NAMES, ISTEP0,
                         device="cpu")
        counts = cuda_build.launch_counts()
    finally:
        cuda_build.reset_launch_counts()
    assert len(eager_graphs) == 1 and len(L.BLOCKS) == 1
    assert counts == {k: N_STEPS if k == "fused_step" else 0
                      for k in counts}
    _assert_same(got, eager[0], torch.stack(
        [getattr(eager[1], k) for k in PPT], 1), eager[1].profiles)


class CountingCapture(L.CapturedStep):
    """Stands in for a CUDA graph's capture on the CPU and counts as the
    real one does: the warm-up's launches thrown away, the recorded step's
    taken as one replay's (``cuda_build.take_launches``), and a replay
    that runs the step eagerly and counts nothing itself."""

    def __init__(self, loop, state0, key, tables):
        self.loop, self.key, self.tables = loop, key, tables
        loop.state = KidState(*[t.clone() for t in state0])
        cuda_build.take_launches(loop.advance)
        self.launches = cuda_build.take_launches(loop.step_in_place)
        self.graph = SimpleNamespace(replay=lambda: cuda_build.take_launches(
            loop.step_in_place))


def _counted(real):
    """``real`` counting each call as a launch, as on a card."""
    def fn(*args, **kwargs):
        fn.launches += 1
        return real(*args, **kwargs)

    fn.launches = 0
    return fn


@pytest.mark.parametrize("graphs", [True, False])
def test_aerosol_steps_count_the_split_kernels(graphs, monkeypatch):
    # n steps of aerosol1d, graphed through a capture that counts as the
    # real one and eagerly, with the split step's kernels counting their
    # CPU calls: each counts n, the capture adding one replay's launches a
    # step
    monkeypatch.setattr(L, "GRAPH_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(L, "CapturedStep", CountingCapture)
    for mod, name in ((ADV, "advect"), (TS, "table_stage"),
                      (A, "fused_rates"), (A, "lookup_stage"),
                      (A, "fused_post")):
        monkeypatch.setattr(mod, name, _counted(getattr(mod, name)))
    case, tables, st0 = _small("aerosol1d")
    cuda_build.reset_launch_counts()
    try:
        got = L.simulate(st0, tables, case, N_STEPS, NAMES, ISTEP0,
                         device="cpu", graphs=graphs)
        counts = cuda_build.launch_counts()
    finally:
        cuda_build.reset_launch_counts()
    split = ("advect", "table_stage", "fused_rates", "lookup_stage",
             "fused_post")
    assert counts == {k: N_STEPS if k in split else 0 for k in counts}
    assert counts["lookup_stage"] == counts["fused_rates"]
    want = _per_step_loop(st0, tables, case, N_STEPS, NAMES, ISTEP0)
    _assert_same(got, *want)


@pytest.mark.parametrize("graphs", [True, False])
def test_aerosol_steps_without_rates_count_the_lookup_kernel(graphs,
                                                             monkeypatch):
    # as above without a rate profile, where fused_rates and the lookup
    # stage write into the rows of fused_post's packed input: n steps, n
    # launches of each kernel, the per-step loop's bits
    monkeypatch.setattr(L, "GRAPH_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(L, "CapturedStep", CountingCapture)
    for mod, name in ((ADV, "advect"), (TS, "table_stage"),
                      (A, "fused_rates"), (A, "lookup_stage"),
                      (A, "fused_post")):
        monkeypatch.setattr(mod, name, _counted(getattr(mod, name)))
    names = tuple(n for n in NAMES if n not in L.RATE_NAMES)
    case, tables, st0 = _small("aerosol1d")
    cuda_build.reset_launch_counts()
    try:
        got = L.simulate(st0, tables, case, N_STEPS, names, ISTEP0,
                         device="cpu", graphs=graphs)
        counts = cuda_build.launch_counts()
    finally:
        cuda_build.reset_launch_counts()
    split = ("advect", "table_stage", "fused_rates", "lookup_stage",
             "fused_post")
    assert counts == {k: N_STEPS if k in split else 0 for k in counts}
    want = _per_step_loop(st0, tables, case, N_STEPS, names, ISTEP0)
    _assert_same(got, *want)


@pytest.mark.parametrize("change", ["same", "dtype", "tables", "names",
                                    "fused"])
def test_graph_cache_keys(change, eager_graphs, monkeypatch):
    case, tables, st0 = _small()
    L.simulate(st0, tables, case, 2, NAMES, ISTEP0, device="cpu")
    names = NAMES
    if change == "dtype":
        tables = _tables(case, torch.float32)
        st0 = KidState(*[t.float() for t in st0])
    elif change == "tables":
        tables = _tables(case)
    elif change == "names":
        names = NAMES[:2]
    elif change == "fused":
        monkeypatch.setenv(L.FUSED_DRIVER_ENV, "1")
    L.simulate(st0, tables, case, 2, names, ISTEP0, device="cpu")
    assert len(eager_graphs) == (1 if change == "same" else 2)
    assert eager_graphs[-1] is tables
    # one capture a block: the block of the first call's dtype keeps its
    # capture only if the second call was on that block with its key
    assert len(L.BLOCKS) == (2 if change == "dtype" else 1)


def test_graph_cache_is_bounded(monkeypatch):
    built = []
    monkeypatch.setattr(L, "build_flow",
                        lambda case, *a: built.append(case) or case)
    cache = L.BlockCache(2)
    for k in ("a", "b", "a", "c", "b", "a"):
        assert cache.get(k, torch.float32, "cpu").flow == k
    # "b" went when "c" came (least recently used), then "a" when "b" came
    assert built == ["a", "b", "c", "b", "a"] and len(cache) == 2
    # a block keeps one capture: another key replaces it
    block, keys = cache.get("a", torch.float32, "cpu"), []

    def build(key):
        return lambda: keys.append(key) or SimpleNamespace(key=key)

    for key in ("x", "x", "y", "x"):
        assert block.capture(key, build(key)).key == key
    assert keys == ["x", "y", "x"]


def test_graphed_result_is_the_callers_own(eager_graphs):
    case, tables, st0 = _small()
    first, out1 = L.simulate(st0, tables, case, 3, NAMES, ISTEP0,
                             device="cpu")
    kept = [t.clone() for t in first]
    kept_rain = out1.ppt_rain.clone()
    loop = L.BLOCKS.get(case, torch.float64,
                        st0.qv.device).captured.loop
    buffers = [t.data_ptr() for t in (*loop.state, loop.ppt, loop.m_buf,
                                      *loop.profiles.values())]
    for t in (*first, out1.ppt_rain, *out1.profiles.values()):
        assert t.data_ptr() not in buffers
    # a later call through the same capture overwrites its buffers only
    L.simulate(_seeded(case, seed=1), tables, case, 3, NAMES, ISTEP0,
               device="cpu")
    assert len(eager_graphs) == 1
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    assert torch.equal(out1.ppt_rain, kept_rain)


def test_failed_capture_raises(monkeypatch):
    def fail(*args):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(L, "GRAPH_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(L, "CapturedStep", fail)
    case, tables, st0 = _small()
    with pytest.raises(RuntimeError, match="capture failed"):
        L.simulate(st0, tables, case, 2, device="cpu")
    L.simulate(st0, tables, case, 2, device="cpu", graphs=False)


def test_second_call_builds_no_flow_pattern(monkeypatch):
    case = tcases.CUMULUS2D
    tables, st0 = _tables(case), L.initial_state(case, torch.float64, "cpu")
    built = []
    for name in ("_psi", "rhow_pattern", "rhou_pattern"):
        fn = getattr(tcases.Case, name)
        monkeypatch.setattr(
            tcases.Case, name,
            lambda *a, _fn=fn, _n=name, **k: built.append(_n) or _fn(*a, **k))
    L.simulate(st0, tables, case, 1, device="cpu")
    assert sorted(built) == ["_psi", "rhou_pattern", "rhow_pattern"]
    L.simulate(st0, tables, case, 1, istep0=1, device="cpu")
    assert len(built) == 3


def test_eager_loop_copies_no_state_back(monkeypatch):
    def copy_back(self):
        raise AssertionError("the eager loop copied its state back")

    monkeypatch.setattr(L.StepLoop, "step_in_place", copy_back)
    case, tables, st0 = _small()
    kept = [t.clone() for t in st0]
    final, _ = L.simulate(st0, tables, case, 3, device="cpu", graphs=False)
    for a, b in zip(st0, kept):                  # the caller's state stays
        assert torch.equal(a, b)
    assert not torch.equal(final.qr, st0.qr)


def _world(monkeypatch, n=1, rank=0):
    """``torch.distributed`` as seen by ``dist.mesh``: ``rank`` of ``n``,
    with no process group (on one rank the exchange is the local wrap)."""
    monkeypatch.setattr(M.dist, "get_world_size", lambda group: n)
    monkeypatch.setattr(M.dist, "get_rank", lambda group: rank)


def test_sharded_path_takes_the_eager_loop(monkeypatch):
    # it asks for the graphed loop unless told otherwise, with the block's
    # ghost columns; on the CPU the loop runs eagerly
    seen = []

    def run_steps(*args):
        seen.append(args)
        return "ran"

    with monkeypatch.context() as m:
        m.setattr(M, "run_steps", run_steps)
        _world(m, 2, 1)
        case = tcases.CUMULUS2D
        local = M.shard_state(L.initial_state(case, torch.float64, "cpu"),
                              1, 2)
        for kwargs in ({}, {"graphs": False}):
            assert M.simulate_sharded(local, None, case, 3, None,
                                      device="cpu", **kwargs) == "ran"
    (*_, block, ghosts, graphs, exchange, in_step), second = seen
    assert graphs is True and second[9] is False
    assert ghosts is block.halo is second[8]
    # on the CPU the step holds the exchange
    assert in_step is True and exchange == M.StepExchange(block.halo, None)
    grid = case.grid()
    np.testing.assert_array_equal(block.flow.w_pat.numpy(),
                                  case.rhow_pattern(grid)[32:64])
    np.testing.assert_array_equal(block.flow.u_pat.numpy(),
                                  case.rhou_pattern(grid)[32:65])

    def fail(*args):
        raise AssertionError("the CPU captured a step")

    monkeypatch.setattr(L, "CapturedStep", fail)
    _world(monkeypatch)
    case, tables, st0 = _small("cumulus2d")
    M.simulate_sharded(st0, tables, case, 2, None, device="cpu")


def _watch_steps(monkeypatch):
    """``StepLoop.advance`` watched: returns the list of the loops whose
    step is running."""
    inside, advance = [], L.StepLoop.advance

    def watched_advance(self):
        inside.append(self)
        try:
            return advance(self)
        finally:
            inside.pop()

    monkeypatch.setattr(L.StepLoop, "advance", watched_advance)
    return inside


@pytest.mark.parametrize("graphs", [True, False])
def test_sharded_exchange_once_a_step_outside_the_step(graphs, eager_graphs,
                                                       monkeypatch):
    # the split placement, which gloo takes with CUDA tensors
    _world(monkeypatch)
    monkeypatch.setattr(M, "exchange_in_step", lambda group, device: False)
    inside = _watch_steps(monkeypatch)
    states, exchange = [], M.Halo.exchange

    def watched_exchange(self, state, group):
        assert not inside, "the halo exchange ran inside the step"
        states.append(state)
        return exchange(self, state, group)

    monkeypatch.setattr(M.Halo, "exchange", watched_exchange)
    case = dataclasses.replace(tcases.CUMULUS2D, nx=16)
    tables, st0 = _tables(case), _seeded(case)
    M.halo_exchange_x.calls = 0
    got = M.simulate_sharded(st0, tables, case, N_STEPS, None, NAMES, ISTEP0,
                             device="cpu", graphs=graphs)
    assert len(states) == M.halo_exchange_x.calls == N_STEPS
    assert len(eager_graphs) == (1 if graphs else 0)
    # the first exchange reads the caller's state; graphed, every later one
    # the captured step's own state buffers
    assert states[0] is st0
    if graphs:
        loop = L.BLOCKS.get(case, torch.float64, st0.qv.device, 0,
                            case.nx).captured.loop
        assert all(st is loop.state for st in states[1:])
    want = L.simulate(st0, tables, case, N_STEPS, NAMES, ISTEP0,
                      device="cpu", graphs=False)
    _assert_same(got, want[0], torch.stack(
        [getattr(want[1], k) for k in PPT], 1), want[1].profiles)


@pytest.mark.parametrize("graphs", [True, False])
def test_sharded_exchange_once_a_step_inside_the_step(graphs, eager_graphs,
                                                      monkeypatch):
    # one rank: the step holds the exchange (its wrap is local)
    _world(monkeypatch)
    inside = _watch_steps(monkeypatch)
    swapped, swap = [], M.Halo.swap

    def watched_swap(self, state, group):
        assert inside, "the in-step exchange ran outside the step"
        swapped.append(state)
        return swap(self, state, group)

    def host_exchange(*args):
        raise AssertionError("a host exchange ran")

    monkeypatch.setattr(M.Halo, "swap", watched_swap)
    monkeypatch.setattr(M.Halo, "exchange", host_exchange)
    case = dataclasses.replace(tcases.CUMULUS2D, nx=16)
    tables, st0 = _tables(case), _seeded(case)
    M.halo_exchange_x.calls = 0
    cuda_build.reset_launch_counts()
    try:
        got = M.simulate_sharded(st0, tables, case, N_STEPS, None, NAMES,
                                 ISTEP0, device="cpu", graphs=graphs)
        counts = cuda_build.launch_counts()
    finally:
        cuda_build.reset_launch_counts()
    # one exchange counted a step; graphed, one a replay (the stand-in
    # capture replays eagerly, so its swap runs inside each replay, where a
    # CUDA graph's replay runs no Python; its warm-up swaps once and counts
    # nothing), and one fused_step launch a replay
    assert M.halo_exchange_x.calls == N_STEPS
    assert len(swapped) == N_STEPS + (1 if graphs else 0)
    assert len(eager_graphs) == (1 if graphs else 0)
    if graphs:
        assert counts == {k: N_STEPS if k == "fused_step" else 0
                          for k in counts}
        loop = L.BLOCKS.get(case, torch.float64, st0.qv.device, 0,
                            case.nx).captured.loop
        assert all(st is loop.state for st in swapped)
    else:
        assert swapped[0] is st0
    want = L.simulate(st0, tables, case, N_STEPS, NAMES, ISTEP0,
                      device="cpu", graphs=False)
    _assert_same(got, want[0], torch.stack(
        [getattr(want[1], k) for k in PPT], 1), want[1].profiles)


@pytest.mark.parametrize("backend, device, n, in_step", [
    ("gloo", "cuda:0", 2, False), ("gloo", "cuda:0", 4, False),
    ("gloo", "cuda:0", 1, True), ("nccl", "cuda:1", 2, True),
    ("nccl", "cuda:0", 4, True), ("gloo", "cpu", 2, True),
    ("gloo", "cpu", 1, True)])
def test_exchange_placement_follows_group_and_device(backend, device, n,
                                                     in_step, monkeypatch):
    # only gloo with CUDA tensors on several ranks stages the slabs through
    # the host, outside the step
    _world(monkeypatch, n)
    monkeypatch.setattr(M.dist, "get_backend", lambda group: backend)
    assert M.exchange_in_step(None, torch.device(device)) is in_step


def test_second_sharded_call_captures_nothing_new(eager_graphs, monkeypatch):
    _world(monkeypatch)
    case = dataclasses.replace(tcases.CUMULUS2D, nx=16)
    tables, st0 = _tables(case), _seeded(case)
    n1, n2 = 5, L.CHUNK_STEPS
    st1, out1 = M.simulate_sharded(st0, tables, case, n1, None, NAMES,
                                   ISTEP0, device="cpu")
    block = L.BLOCKS.get(case, torch.float64, st0.qv.device, 0, case.nx)
    first = block.captured
    st2, out2 = M.simulate_sharded(st1, tables, case, n2, None, NAMES,
                                   ISTEP0 + n1, device="cpu")
    assert len(eager_graphs) == 1 and block.captured is first
    assert len(L.BLOCKS) == 1
    # the two calls are one call of n1 + n2 steps
    want = L.simulate(st0, tables, case, n1 + n2, NAMES, ISTEP0,
                      device="cpu", graphs=False)
    cat = torch.cat([torch.stack([getattr(o, k) for k in PPT], 1)
                     for o in (out1, out2)])
    _assert_same((st2, want[1]), want[0], cat, {
        k: torch.cat([out1.profiles[k], out2.profiles[k]]) for k in NAMES})


def test_take_and_add_launches():
    cuda_build.reset_launch_counts()
    try:
        F.fused_step.launches = 5

        def launch_twice():
            F.fused_step.launches += 2

        assert cuda_build.take_launches(launch_twice)["fused_step"] == 2
        assert F.fused_step.launches == 5
        cuda_build.add_launches({"fused_step": 3}, 4)
        assert cuda_build.launch_counts()["fused_step"] == 17
    finally:
        cuda_build.reset_launch_counts()
