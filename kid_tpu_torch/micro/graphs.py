"""CUDA graphs of the port's compiled calls: the counterpart of the
reference's ``jax.jit`` on ``batched_microphysics`` and ``mp_driver_3d``
(and, through ``capture``, of its ``jit`` over the time loop's step).

``run(fn, args, static, graphs)`` calls ``fn(*args)``.  On a device of
``GRAPH_DEVICE_TYPES`` with ``graphs`` it goes through a ``CapturedCall``
instead: ``fn`` captured once on static copies of its tensor arguments,
then one replay a call, after the call's arguments are copied into those
copies.  ``GRAPHS`` keeps the captured calls by ``static`` (what the
reference's ``jit`` makes static: the entry point, its config, step and
switches, and the identity of its tables) and the shape, dtype and device
of every argument, and drops the least recently used beyond
``GRAPH_CACHE_SIZE``: each holds its graph's memory pool.  The outputs a
caller gets are clones, its own.  A failed capture raises; nothing falls
back to the eager call.
"""
from __future__ import annotations

import collections

import torch

from .. import spans
from . import cuda_build

# the device types on which ``run`` captures (the tests put a stand-in
# capture on the CPU)
GRAPH_DEVICE_TYPES = ("cuda",)
# captured calls kept (``GRAPHS``)
GRAPH_CACHE_SIZE = 8


def capture(warm_up, record, device, error_mode: str = "global"):
    """Load the kernel libraries, run ``warm_up()`` once on a side stream
    (its results and its launches are thrown away: it makes every cached
    device constant and loads every torch kernel before the capture), then
    capture ``record()`` as a CUDA graph in ``error_mode`` (the
    ``capture_error_mode`` of ``torch.cuda.graph``).  Returns (graph, the
    kernel launches of one replay, ``record()``'s result: the graph's
    outputs)."""
    cuda_build.build()
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        cuda_build.take_launches(warm_up)
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    result = []
    with torch.cuda.graph(graph, capture_error_mode=error_mode):
        launches = cuda_build.take_launches(
            lambda: result.append(record()))
    return graph, launches, result[0]


def clone(x):
    """``x`` with every tensor in it cloned (tensors, None, dicts, tuples
    and named tuples)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [clone(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class CapturedCall:
    """``fn(*args)`` captured on static copies of ``args`` (contiguous, of
    the caller's shapes; None stays None).  The capture keeps ``fn``, and
    with it whatever its ``key`` names by identity (the tables): the graph
    reads their memory, and their ``id`` stays their own while the capture
    lives."""

    def __init__(self, fn, args: tuple, key):
        with spans.span("kid.capture"):
            self.fn, self.key = fn, key
            self.args = tuple(
                None if a is None
                else a.clone(memory_format=torch.contiguous_format)
                for a in args)
            dev = next(a.device for a in self.args if a is not None)

            def call():
                return self.fn(*self.args)

            self.graph, self.launches, self.outputs = capture(call, call,
                                                              dev)

    def __call__(self, args: tuple):
        """One replay on ``args``; returns clones of the outputs.  Spans:
        ``kid.call.copy_in``, ``kid.call.replay``, ``kid.call.clone_out``."""
        with spans.span("kid.call.copy_in"):
            for buf, a in zip(self.args, args):
                if buf is not None:
                    buf.copy_(a)
        with spans.span("kid.call.replay"):
            self.graph.replay()
            cuda_build.add_launches(self.launches)
        with spans.span("kid.call.clone_out"):
            return clone(self.outputs)


class LRUCache:
    """Entries by key, at most ``size``: the least recently used goes
    first (a ``CapturedCall``, and with it its graph and memory; a driver
    ``Block``)."""

    def __init__(self, size: int):
        self.size = size
        self._entries = collections.OrderedDict()

    def get(self, key, build):
        """The entry of ``key``, made by ``build()`` if there is none (the
        least recently used entry is dropped first if the cache is
        full)."""
        entry = self._entries.pop(key, None)
        if entry is None:
            while len(self._entries) >= self.size:
                self._entries.popitem(last=False)
            entry = build()
        self._entries[key] = entry
        return entry

    def clear(self):
        self._entries.clear()

    def __len__(self):
        return len(self._entries)


GRAPHS = LRUCache(GRAPH_CACHE_SIZE)


def run(fn, args: tuple, static: tuple, graphs: bool = True):
    """``fn(*args)``, through the captured call of (``static``, the shape,
    dtype and device of each argument) when ``graphs`` is set and the
    arguments lie on a device of ``GRAPH_DEVICE_TYPES``; eagerly
    otherwise.  ``args`` are tensors or None; ``static`` must name
    everything else ``fn`` depends on.  The result is the caller's own.
    The key and the cache's lookup (and a capture, if one is made) are
    the span ``kid.call.lookup``."""
    dev = next(a.device for a in args if a is not None)
    if not (graphs and dev.type in GRAPH_DEVICE_TYPES):
        return fn(*args)
    with spans.span("kid.call.lookup"):
        key = (static, tuple(None if a is None
                             else (tuple(a.shape), a.dtype, a.device)
                             for a in args))
        call = GRAPHS.get(key, lambda: CapturedCall(fn, args, key))
    return call(args)
