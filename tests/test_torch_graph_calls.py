"""The port's graphed entry points on the CPU: ``batched_microphysics`` and
``mp_driver_3d`` through ``micro/graphs.py``, the counterpart of the
reference's ``jax.jit`` on each.

  * one call of each (mixed and aerosol, rate profiles on and off; the
    adapter with its radii), with the kernel wrappers replaced by
    shape-correct stubs on the meta device, makes no host sync and no copy
    between host and device after a warm-up call: what a capture records;
  * with a stand-in capture on the CPU, whose replay runs the call again
    into the captured outputs: the cache keys on every element of its key
    and is bounded; a replay adds the captured launches; the caller's
    outputs are its own; a failed capture raises; ``graphs=False`` runs
    eagerly; graphed equals eager bit for bit, broadcast inputs included;
  * with a stand-in capture that keeps nothing of the call (as a CUDA graph
    keeps no Python object), the cached capture keeps the caller's tables
    alive, so that the graph's reads stay valid and their ``id`` in the key
    stays their own.
"""
from __future__ import annotations

import dataclasses
import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kid_tpu_torch.config import MicroConfig
from kid_tpu_torch.driver import wrf_adapter as W
from kid_tpu_torch.micro import ColumnState, batched_microphysics, cuda_build
from kid_tpu_torch.micro import fused_step as F
from kid_tpu_torch.micro import graphs as G
from kid_tpu_torch.micro import solver as S
from kid_tpu_torch.micro import split_step as A
from kid_tpu_torch.micro import table_stage as TS
from kid_tpu_torch.tables.cache import get_tables
from test_torch_diag_wrf import _mixed_tile
from test_torch_graph_loop import NoHostSync, _stub_kernels
from test_torch_solver import _make_batch

torch.set_num_threads(2)

CFGS = {"mixed": MicroConfig(iiwarm=False),
        "aerosol": MicroConfig(iiwarm=False, is_aerosol_aware=True)}


@pytest.fixture(autouse=True)
def _fresh_graphs():
    G.GRAPHS.clear()
    cuda_build.reset_launch_counts()
    yield
    G.GRAPHS.clear()
    cuda_build.reset_launch_counts()


def _tables(dtype=torch.float64, device="cpu"):
    return S.device_tables(get_tables(iiwarm=False), dtype, device)


def _batch(ncol=4, nz=40, seed=0, dtype=torch.float64, device="cpu"):
    """A seeded batch with ``pres`` broadcast from one row, as the bench
    and the WRF tiles pass it, and a seeded w."""
    state, pres, dzq = _make_batch(ncol, nz, seed)
    w = np.random.default_rng(seed).uniform(-1.0, 3.0, (ncol, nz))

    def put(a):
        return torch.tensor(a, dtype=dtype, device=device)

    st = ColumnState(**{k: put(v) for k, v in state.items()})
    return st, put(pres[0]).expand(ncol, nz), put(w), put(dzq)


def _tile(dtype=torch.float64, device="cpu"):
    fields, dt, acc, _ = _mixed_tile()

    def put(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return tuple(map(put, fields)), dt, tuple(map(put, acc))


def _leaves(x):
    """The tensors of a nested output, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return []


# ---- capture safety: no host sync in a call ------------------------------

CALLS = ["mixed", "mixed-rates", "aerosol", "aerosol-rates", "mp_driver_3d"]


def _call(name, dev, dtype=torch.float32, graphs=False):
    """A function running the entry point ``name`` on ``dev``."""
    if name == "mp_driver_3d":
        fields, dt, acc = _tile(dtype, dev)
        tables = _tables(dtype, dev)
        return lambda: W.mp_driver_3d(*fields, dt, *acc, tables,
                                      MicroConfig(iiwarm=False),
                                      want_eff_rad=True, device=dev,
                                      graphs=graphs)
    cfg = CFGS[name.split("-")[0]]
    st, pres, w, dzq = _batch(dtype=dtype, device=dev)
    tables = _tables(dtype, dev)
    return lambda: batched_microphysics(
        st, pres, w, dzq, 10.0, tables, cfg, want_rates=name.endswith(
            "rates"), device=dev, graphs=graphs)


@pytest.mark.parametrize("name", CALLS)
def test_call_makes_no_host_sync(name, monkeypatch):
    calls = []
    _stub_kernels(monkeypatch, calls)
    call = _call(name, torch.device("meta"))
    call()                        # the warm-up, as before a capture
    n_warm = len(calls)
    with NoHostSync():
        out = call()              # what the capture records
    want = ["table_stage"] + (["fused_rates", "lookup_stage", "fused_post"]
                              if name.startswith("aerosol")
                              else ["fused_step"])
    assert calls[n_warm:] == want
    assert all(t.device.type == "meta" for t in _leaves(out))


# ---- the capture cache, with a capture that replays eagerly ---------------

def eager_capture(warm_up, record, device):
    """Stands in for ``graphs.capture`` on the CPU: the warm-up as the real
    one, then a "graph" whose replay runs ``record()`` again and copies its
    result into the captured outputs (counting no launch: the caller adds
    the captured ones)."""
    eager_capture.built.append(device)
    cuda_build.take_launches(warm_up)
    out = []
    launches = cuda_build.take_launches(lambda: out.append(record()))

    def replay():
        fresh = []
        cuda_build.take_launches(lambda: fresh.append(record()))
        for a, b in zip(_leaves(out[0]), _leaves(fresh[0])):
            a.copy_(b)

    return SimpleNamespace(replay=replay), launches, out[0]


def _counted(real):
    """``real`` counting each call as a launch."""
    def fn(*args, **kwargs):
        fn.launches += 1
        return real(*args, **kwargs)

    fn.launches = 0
    return fn


@pytest.fixture
def eager_graphs(monkeypatch):
    """The graphed path on the CPU and the meta device, through
    ``eager_capture``, with kernel wrappers that count their CPU calls as
    launches."""
    eager_capture.built = []
    monkeypatch.setattr(G, "GRAPH_DEVICE_TYPES", ("cuda", "cpu", "meta"))
    monkeypatch.setattr(G, "capture", eager_capture)
    for mod, name in ((TS, "table_stage"), (F, "fused_step"),
                      (A, "fused_rates"), (A, "lookup_stage"),
                      (A, "fused_post")):
        monkeypatch.setattr(mod, name, _counted(getattr(mod, name)))
    return eager_capture.built


@pytest.mark.parametrize("name", CALLS)
def test_graphed_equals_eager_and_counts_replays(name, eager_graphs):
    eager = _call(name, "cpu", torch.float64, graphs=False)()
    n_eager = cuda_build.launch_counts()
    assert not eager_graphs
    cuda_build.reset_launch_counts()
    graphed = _call(name, "cpu", torch.float64, graphs=True)
    outs = [graphed() for _ in range(3)]
    assert len(eager_graphs) == 1 and len(G.GRAPHS) == 1
    # the capture and its warm-up add no launch; each replay adds one
    # call's
    assert cuda_build.launch_counts() == {k: 3 * n for k, n in
                                          n_eager.items()}
    assert sum(n_eager.values()) == (4 if name.startswith("aerosol") else 2)
    for out in outs:
        got, want = _leaves(out), _leaves(eager)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


BATCH_CHANGES = ["same", "shape", "dtype", "cfg", "dt", "rates", "tables",
                 "w"]


@pytest.mark.parametrize("change", BATCH_CHANGES)
def test_batched_cache_keys(change, eager_graphs):
    st, pres, w, dzq = _batch()
    cfg, tables = CFGS["mixed"], _tables()
    args = dict(dt=10.0, cfg=cfg, rates=False)
    batched_microphysics(st, pres, w, dzq, 10.0, tables, cfg,
                         want_rates=False, device="cpu")
    if change == "shape":
        st, pres, w, dzq = _batch(ncol=3)
    elif change == "dtype":
        st, pres, w, dzq = _batch(dtype=torch.float32)
        tables = _tables(torch.float32)
    elif change == "cfg":
        args["cfg"] = dataclasses.replace(cfg, set_nc=50.0)
    elif change == "dt":
        args["dt"] = 5.0
    elif change == "rates":
        args["rates"] = True
    elif change == "tables":
        tables = _tables()
    elif change == "w":           # no w: another signature
        w = None
    batched_microphysics(st, pres, w, dzq, args["dt"], tables, args["cfg"],
                         want_rates=args["rates"], device="cpu")
    assert len(eager_graphs) == (1 if change == "same" else 2)
    assert len(G.GRAPHS) == len(eager_graphs)


@pytest.mark.parametrize("change", ["same", "radii", "shape"])
def test_mp_driver_3d_cache_keys(change, eager_graphs):
    fields, dt, acc = _tile()
    tables, cfg = _tables(), MicroConfig(iiwarm=False)
    W.mp_driver_3d(*fields, dt, *acc, tables, cfg, device="cpu")
    radii = change == "radii"
    if change == "shape":
        fields = tuple(f[:, :, :2] for f in fields)
        acc = tuple(a[:, :2] for a in acc)
    _, _, eff = W.mp_driver_3d(*fields, dt, *acc, tables, cfg,
                               want_eff_rad=radii, device="cpu")
    assert (eff is not None) == radii
    assert len(eager_graphs) == (1 if change == "same" else 2)


def test_run_keys_on_the_device(eager_graphs):
    for dev in ("cpu", "meta", "cpu"):
        out = G.run(lambda x: 2.0 * x, (torch.ones(3, device=dev),),
                    ("double",))
        assert out.device.type == dev
    assert eager_graphs == [torch.device("cpu"), torch.device("meta")]


def test_graph_cache_is_bounded():
    cache, built = G.LRUCache(2), []

    def build(key):
        return lambda: built.append(key) or SimpleNamespace(key=key)

    for k in ("a", "b", "a", "c", "b", "a"):
        assert cache.get(k, build(k)).key == k
    # "b" went when "c" came (least recently used), then "a" when "b" came
    assert built == ["a", "b", "c", "b", "a"] and len(cache) == 2


def test_graphed_outputs_are_the_callers_own(eager_graphs):
    st, pres, w, dzq = _batch()
    cfg, tables = CFGS["mixed"], _tables()

    def call(s):
        return batched_microphysics(s, pres, w, dzq, 10.0, tables, cfg,
                                    device="cpu")

    first = call(st)
    kept = [t.clone() for t in _leaves(first)]
    captured = next(iter(G.GRAPHS._entries.values()))
    buffers = {t.data_ptr() for t in _leaves(captured.outputs)
               + list(captured.args[:-1])}
    assert not buffers & {t.data_ptr() for t in _leaves(first)}
    # a second call through the same capture, fed the first's state (as
    # the bench feeds it), overwrites the capture's buffers only
    second = call(first[0])
    assert len(eager_graphs) == 1
    for a, b in zip(_leaves(first), kept):
        assert torch.equal(a, b)
    assert not torch.equal(second[0].qr, first[0].qr)
    # changing a caller's output changes nothing the next call returns
    first[0].qv.fill_(-1.0)
    again = call(st)
    for a, b in zip(_leaves(again), kept):
        assert torch.equal(a, b)


def test_failed_capture_raises(monkeypatch):
    def fail(*args):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(G, "GRAPH_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(G, "capture", fail)
    for graphs in (True, False):
        for name in ("mixed", "mp_driver_3d"):
            call = _call(name, "cpu", torch.float64, graphs=graphs)
            if graphs:
                with pytest.raises(RuntimeError, match="capture failed"):
                    call()
            else:
                call()
    assert len(G.GRAPHS) == 0


def test_graphs_false_runs_eagerly(eager_graphs):
    for name in CALLS:
        _call(name, "cpu", torch.float64, graphs=False)()
    assert not eager_graphs and len(G.GRAPHS) == 0
    _call("mixed", "cpu", torch.float64, graphs=True)()
    assert len(eager_graphs) == 1


def forgetful_capture(warm_up, record, device):
    """Stands in for ``graphs.capture`` and, like a CUDA graph, keeps no
    reference to ``record`` or to what it reads."""
    cuda_build.take_launches(warm_up)
    out = []
    launches = cuda_build.take_launches(lambda: out.append(record()))
    return SimpleNamespace(replay=lambda: None), launches, out[0]


@pytest.mark.parametrize("name", ["batched_microphysics", "mp_driver_3d"])
def test_capture_keeps_the_tables_alive(name, monkeypatch):
    monkeypatch.setattr(G, "GRAPH_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(G, "capture", forgetful_capture)
    tables = _tables()
    table = weakref.ref(tables.racs)
    if name == "mp_driver_3d":
        fields, dt, acc = _tile()
        W.mp_driver_3d(*fields, dt, *acc, tables, MicroConfig(iiwarm=False),
                       device="cpu")
    else:
        st, pres, w, dzq = _batch()
        batched_microphysics(st, pres, w, dzq, 10.0, tables, CFGS["mixed"],
                             device="cpu")
    del tables
    gc.collect()
    assert len(G.GRAPHS) == 1 and table() is not None
    G.GRAPHS.clear()
    gc.collect()
    assert table() is None
