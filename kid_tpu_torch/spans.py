"""The port's spans: its host work at each layer boundary, named, on the
profiler's clock.  The one span facility of the package.

    from kid_tpu_torch import spans
    with spans.span("kid.chunk"):
        ...

Off, the default, ``span`` tests one module flag and returns a shared
do-nothing context: it reads no clock, records nothing and enters no
``record_function``.  On (``enable()``), each span records a ``Span``
with ``time.perf_counter_ns()``; where a profiler is running when it
opens, it also enters ``torch.profiler.record_function(name)``, so that
the profiler draws the same interval on the timeline that holds the
device's activities: an idle gap of the device can then be put down to
the program's own host work.  (Without a profiler a ``record_function``
would draw nothing and cost some microseconds a span, which the spans'
own host times would hold.)  A span never synchronises the device.  No span
is entered once a replay or once a kernel: a span wraps a run of replays
from outside, and a replay of a CUDA graph enters none of the spans that
its capture passed through.

Names (the layers; ``PERF.md`` lists the metric that reads each):

  driver loop   ``kid.simulate`` (``driver/loop.py::simulate``, and
                ``dist/mesh.py::simulate_sharded`` for a rank), with
                ``kid.simulate.prepare`` (block lookup, key, capture or
                reuse, ``CapturedStep.load``), a ``kid.chunk`` for each
                chunk of ``drive`` with ``kid.chunk.upload``,
                ``kid.chunk.replay`` and ``kid.chunk.streams``, and
                ``kid.simulate.finish`` (the returned state's clones)
  host adapter  ``kid.mp_driver_3d``, with ``kid.call.lookup``,
                ``kid.call.copy_in``, ``kid.call.replay`` and
                ``kid.call.clone_out`` (``micro/graphs.py``)
  captures      ``kid.capture`` (``CapturedCall`` and ``CapturedStep``)
  set-up        ``kid.setup.tables``, ``kid.setup.build``,
                ``kid.setup.flow``
  distribution  ``kid.halo_exchange``
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.profiler import record_function

PREFIX = "kid."

ON = False


class Span(NamedTuple):
    """One recorded span.  ``parent``: the index, in the same ``take()``,
    of the span that encloses it on its thread (-1: none).  ``call``: the
    sequence number of the outermost span it lies in, the same for every
    span of one call.  ``istep0`` and ``steps``: those of the
    ``kid.simulate`` call it lies in (-1 elsewhere).  ``profiled``: a
    profiler was running when it opened."""

    name: str
    parent: int
    start_ns: int
    end_ns: int
    call: int
    istep0: int
    steps: int
    profiled: bool


_records: list = []   # [index, name, parent, start, end, call, i0, n, prof]
_lock = threading.Lock()     # ``_records``: appended by any thread, swapped
_index = itertools.count()
_calls = itertools.count()
_local = threading.local()   # .open: this thread's open spans, innermost last


class _Off:
    """What ``span`` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


class _Live:
    """An open span: its record, and the profiler's ``record_function``."""

    __slots__ = ("name", "istep0", "steps", "rec", "rf")

    def __init__(self, name: str, istep0: int, steps: int):
        self.name, self.istep0, self.steps = name, istep0, steps

    def __enter__(self):
        stack = _open()
        if stack:
            up = stack[-1].rec
            parent, call = up[0], up[5]
            istep0 = up[6] if self.istep0 < 0 else self.istep0
            steps = up[7] if self.steps < 0 else self.steps
        else:
            parent, call = -1, next(_calls)
            istep0, steps = self.istep0, self.steps
        profiled = torch.autograd._profiler_enabled()
        self.rf = record_function(self.name) if profiled else None
        if profiled:
            self.rf.__enter__()
        self.rec = [next(_index), self.name, parent, 0, None, call, istep0,
                    steps, profiled]
        with _lock:
            _records.append(self.rec)
        stack.append(self)
        self.rec[3] = time.perf_counter_ns()

    def __exit__(self, typ, value, tb):
        self.rec[4] = time.perf_counter_ns()
        _open().pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def _open() -> list:
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def span(name: str, istep0: int = -1, steps: int = -1):
    """A context manager that records the host work inside it as ``name``
    while spans are on, and does nothing while they are off.  ``istep0``
    and ``steps``: a ``simulate`` call's, which the spans inside it carry
    too."""
    if not ON:
        return _OFF
    return _Live(name, istep0, steps)


def enable():
    """Spans on, in every thread, from now."""
    global ON
    ON = True


def disable():
    """Spans off from now; what was recorded stays until ``take()``."""
    global ON
    ON = False


def take() -> list:
    """Every span recorded and ended since the last ``take()``, as
    ``Span``s in the order they opened, and the record cleared.  Take with
    no span open: one open now is neither returned nor, once it ends,
    recorded."""
    global _records
    with _lock:
        recs, _records = _records, []
    done = [r for r in recs if r[4] is not None]
    where = {r[0]: i for i, r in enumerate(done)}
    return [Span(r[1], where.get(r[2], -1), r[3], r[4], r[5], r[6], r[7],
                 bool(r[8])) for r in done]

