"""The port's spans (``kid_tpu_torch/spans.py``) on the CPU.

  * off, the default, a span records nothing and the profiler sees no
    ``kid.*`` event;
  * on, ``simulate`` over 40 steps gives ``kid.simulate`` holding
    ``kid.simulate.prepare``, three ``kid.chunk``s, each with
    ``upload``, ``replay`` and ``streams``, then ``finish``, every one
    carrying the call's sequence number, ``istep0`` and steps;
  * ``mp_driver_3d`` through the tests' stand-in capture gives
    ``kid.capture`` on the first call only (inside ``kid.call.lookup``),
    then ``lookup``, ``copy_in``, ``replay`` and ``clone_out`` under
    ``kid.mp_driver_3d`` on every call;
  * under ``torch.profiler`` each span is drawn around the ``aten::`` ops
    issued inside it, and the profiler's interval and the span's own
    record agree: the shared clock;
  * one step of each path makes no host sync with spans on;
  * the halo exchange's span, which ``dist.launch.profiled_window``
    counts with spans on for its window only;
  * a sharded rank's ``simulate`` with its exchanges under the spans of
    the prepare and the replays;
  * ``take`` with a span open, and threads that each keep their own
    nesting.
"""
from __future__ import annotations

import dataclasses
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kid_tpu_torch import spans
from kid_tpu_torch.dist import launch as DL
from kid_tpu_torch.dist import mesh as M
from kid_tpu_torch.driver import cases as tcases
from kid_tpu_torch.driver import loop as L
from kid_tpu_torch.driver import wrf_adapter as W
from kid_tpu_torch.micro import graphs as G
from test_torch_graph_calls import _tables as _call_tables
from test_torch_graph_calls import _tile, eager_graphs  # noqa: F401
import test_torch_graph_loop as GL
from test_torch_graph_loop import PATHS, _seeded, _tables, _world

torch.set_num_threads(2)

CHUNK = ["kid.chunk", "kid.chunk.upload", "kid.chunk.replay",
         "kid.chunk.streams"]
CALL = ["kid.mp_driver_3d", "kid.call.lookup", "kid.call.copy_in",
        "kid.call.replay", "kid.call.clone_out"]


@pytest.fixture(autouse=True)
def _fresh():
    """Spans off and nothing recorded around each test, fresh caches."""
    was = spans.ON
    spans.disable()
    spans.take()
    L.BLOCKS.clear()
    G.GRAPHS.clear()
    yield
    spans.disable()
    spans.take()
    L.BLOCKS.clear()
    G.GRAPHS.clear()
    if was:
        spans.enable()


@pytest.fixture
def on():
    spans.enable()


def _small(nx=2):
    case = dataclasses.replace(tcases.MIXED1, nx=nx)
    return case, _tables(case), _seeded(case)


def _simulate(n_steps=40, istep0=10, inputs=None):
    """``simulate`` on the small case, after the spans its inputs made
    (``kid.setup.tables``) are taken."""
    case, tables, st0 = inputs or _small()
    spans.take()
    return L.simulate(st0, tables, case, n_steps, istep0=istep0,
                      device="cpu")


def test_off_records_nothing_and_draws_nothing():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _simulate(20)
    assert spans.take() == []
    assert not [e.name for e in prof.events()
                if e.name.startswith(spans.PREFIX)]
    assert spans.span("kid.simulate") is spans.span("kid.chunk")


def test_simulate_spans_nest_by_chunk(on):
    _simulate(40, istep0=10)
    got = spans.take()
    names = [s.name for s in got]
    assert names == (["kid.simulate", "kid.setup.flow",
                      "kid.simulate.prepare"] + CHUNK * 3
                     + ["kid.simulate.finish"])
    top = got[0]
    assert top.parent == -1 and (top.istep0, top.steps) == (10, 40)
    for i, s in enumerate(got[1:], 1):
        want = {"kid.chunk.upload": "kid.chunk",
                "kid.chunk.replay": "kid.chunk",
                "kid.chunk.streams": "kid.chunk"}.get(s.name, "kid.simulate")
        assert got[s.parent].name == want, (i, s.name)
        assert (s.call, s.istep0, s.steps) == (top.call, 10, 40)
        assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
        assert not s.profiled
    # the block's flow is built before the prepare, which ends before the
    # first chunk begins
    flow, prep, first = got[1], got[2], got[3]
    assert flow.end_ns <= prep.start_ns
    assert prep.end_ns <= first.start_ns
    # a second call is a call of its own, with no flow to build
    _simulate(16, istep0=50)
    again = spans.take()
    assert [s.name for s in again] == (["kid.simulate",
                                        "kid.simulate.prepare"] + CHUNK
                                       + ["kid.simulate.finish"])
    assert {s.call for s in again} == {again[0].call} != {top.call}
    assert {(s.istep0, s.steps) for s in again} == {(50, 16)}


def test_mp_driver_3d_spans_through_the_stand_in_capture(eager_graphs, on):
    fields, dt, acc = _tile()
    tables = _call_tables()
    spans.take()
    for _ in range(2):
        W.mp_driver_3d(*fields, dt, *acc, tables,
                       W.MicroConfig(iiwarm=False), device="cpu")
    got = spans.take()
    calls = {}
    for s in got:
        calls.setdefault(s.call, []).append(s)
    first, second = calls.values()
    assert [s.name for s in first] == CALL[:2] + ["kid.capture"] + CALL[2:]
    assert [s.name for s in second] == CALL
    for call in (first, second):
        top = got.index(call[0])
        assert call[0].parent == -1
        for s in call[1:]:
            want = ("kid.call.lookup" if s.name == "kid.capture"
                    else "kid.mp_driver_3d")
            assert got[s.parent].name == want
            assert got[s.parent].call == got[top].call
    assert len(eager_graphs) == 1


def test_the_profiler_draws_each_span_around_its_ops(on):
    inputs = _small()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _simulate(20, inputs=inputs)
    got = spans.take()
    assert got and all(s.profiled for s in got)
    events = prof.events()
    drawn = [e for e in events if e.name.startswith(spans.PREFIX)]
    # one drawn interval a span, in the same order
    assert [e.name for e in sorted(drawn, key=lambda e: e.time_range.start)
            ] == [s.name for s in got]
    inside = 0
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith(spans.PREFIX):
            up = up.cpu_parent
        if up is None:
            continue
        inside += 1
        assert up.time_range.start <= e.time_range.start
        assert e.time_range.end <= up.time_range.end
    assert inside > 100
    # the profiler's interval and the span's own agree
    top = [e for e in drawn if e.name == "kid.simulate"][0]
    mine = (got[0].end_ns - got[0].start_ns) * 1e-3
    assert abs(top.time_range.elapsed_us() - mine) <= 0.05 * mine + 2000


@pytest.mark.parametrize("name", list(PATHS) + ["sharded",
                                                "sharded_in_step"])
def test_step_makes_no_host_sync_with_spans_on(name, monkeypatch, on):
    GL.test_step_makes_no_host_sync(name, monkeypatch)
    got = [s.name for s in spans.take()]
    if name == "sharded_in_step":       # the warm-up's swap and the step's
        assert got.count("kid.halo_exchange") == 2


def test_halo_exchange_span_and_the_profiled_window(monkeypatch):
    _world(monkeypatch)
    q = torch.arange(24.0).reshape(6, 4)

    def two_exchanges():
        M.halo_exchange_x(q, None)
        M.halo_exchange_x(q, None)

    with M.spans.span("kid.halo_exchange"):      # off: nothing
        pass
    two_exchanges()
    assert spans.take() == []
    out = DL.profiled_window(two_exchanges, 2, torch.device("cpu"),
                             enter=lambda: None)
    assert out["host_exchange_calls"] == 1.0
    assert not spans.ON                          # off again after it
    assert [s.name for s in spans.take()] == ["kid.halo_exchange"] * 2


def test_a_sharded_rank_spans_its_exchanges(monkeypatch, on):
    # the split placement: the first exchange in the prepare, the others
    # between the steps, inside the chunks' replays
    _world(monkeypatch)
    monkeypatch.setattr(M, "exchange_in_step", lambda group, device: False)
    case = dataclasses.replace(tcases.CUMULUS2D, nx=16)
    tables, st0 = _tables(case), _seeded(case)
    spans.take()
    M.simulate_sharded(st0, tables, case, 20, None, istep0=4, device="cpu")
    got = spans.take()
    top = got[0]
    assert (top.name, top.parent, top.istep0, top.steps) == (
        "kid.simulate", -1, 4, 20)
    assert {s.call for s in got} == {top.call}
    under = {}
    for s in got[1:]:
        under.setdefault(got[s.parent].name, []).append(s.name)
    assert under["kid.simulate"] == ["kid.setup.flow",
                                     "kid.simulate.prepare", "kid.chunk",
                                     "kid.chunk", "kid.simulate.finish"]
    assert under["kid.simulate.prepare"] == ["kid.halo_exchange"]
    assert under["kid.chunk.replay"] == ["kid.halo_exchange"] * 19


def test_take_leaves_out_a_span_still_open(on):
    with spans.span("kid.simulate"):
        with spans.span("kid.chunk"):
            pass
        assert [s.name for s in spans.take()] == ["kid.chunk"]
    assert spans.take() == []
    with spans.span("kid.chunk"):
        pass
    (again,) = spans.take()
    assert again.parent == -1


def test_threads_record_their_own_nesting(on):
    n_threads, n = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with spans.span("kid.simulate", 0, 1):
                    with spans.span("kid.chunk"):
                        pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    got = spans.take()
    assert len(got) == 2 * n_threads * n
    outer = [s for s in got if s.name == "kid.simulate"]
    assert len({s.call for s in outer}) == n_threads * n
    for s in got:
        if s.name == "kid.chunk":
            up = got[s.parent]
            assert up.name == "kid.simulate" and up.call == s.call
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
