"""The traced segment of a ``--trace 1`` run: ``torch.profiler`` (CUPTI)
around a fixed piece of the cell's work, reduced to what the per-layer
metrics read.

The device's busy time is the union of every device activity's interval
(kernels, copies and fills), so overlapping streams count once; the
window is the host clock from a synchronised start to a synchronised
end.  Device time by class (``classes.kernel_class``) is the sum of the
activities' durations."""
from __future__ import annotations

import time
from typing import NamedTuple

from .classes import CLASSES, kernel_class

TOP = 10
NAME_CHARS = 160
# the harness's own host spans (``record_function``), which the profiler
# also draws on the device's timeline as annotations: not activity
SPAN = "kidbench."


class TraceSummary(NamedTuple):
    units: int          # steps or calls in the traced segment
    window_s: float     # host clock of the segment
    busy_s: float       # union of the device activities' intervals
    by_class: dict      # class -> device seconds (summed durations)
    device_ops: list    # [[name, seconds]]: the TOP largest by name
    idle_gaps: list     # [[host span, seconds]]: the TOP longest gaps
    per_rank: list      # each rank's ``by_class`` (one: this one's)


def union_seconds(intervals: list) -> tuple:
    """(seconds covered by ``intervals`` [(start_us, end_us)], the gaps
    between them [(start_us, end_us)])."""
    busy, gaps, cur = 0.0, [], None
    for a, b in sorted(intervals):
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy * 1e-6, gaps


def summarize(device: list, host: list, units: int,
              window_s: float) -> TraceSummary:
    """``device``: [(name, start_us, end_us)] of the device activities;
    ``host``: the same of the host's spans and ops."""
    busy_s, gaps = union_seconds([(a, b) for _, a, b in device])
    by_class = dict.fromkeys(CLASSES, 0.0)
    by_name = {}
    for name, a, b in device:
        by_class[kernel_class(name)] += (b - a) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    idle = []
    for g0, g1 in longest:
        mid = 0.5 * (g0 + g1)
        inside = [(b - a, name) for name, a, b in host if a <= mid <= b]
        idle.append([min(inside)[1][:NAME_CHARS] if inside else "host",
                     (g1 - g0) * 1e-6])
    return TraceSummary(units, window_s, busy_s, by_class,
                        [[n[:NAME_CHARS], s] for n, s in ops], idle,
                        [by_class])


def traced(fn, units: int, device) -> TraceSummary:
    """``fn()`` under the profiler, between two synchronisations; spans
    named ``SPAN...`` mark the harness's own host work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        row = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type != DeviceType.CUDA:
            host.append(row)
        elif not (e.name.startswith(SPAN)
                  or getattr(e, "is_user_annotation", False)):
            dev.append(row)
    if not dev:
        raise RuntimeError("the profiler saw no device activity")
    return summarize(dev, host, units, window_s)
