"""The last line's keys, the window's arithmetic on a fake clock, the
trace's reduction and the kernel-name classes."""
import json
from pathlib import Path

import pytest

from kidbench import drive, run, trace
from kidbench.classes import COPY, NCCL, OWN, TORCH, kernel_class
from kidbench.manifest import find_cell

DATA = Path(__file__).resolve().parent / "data"


def fake_outcome(traced):
    summary = trace.summarize(
        [("void fused_step_kernel<float>(...)", 0.0, 400.0),
         ("void at::native::elementwise_kernel<...>", 500.0, 900.0)],
        [("kidbench.simulate", 0.0, 1000.0)], units=2, window_s=1e-3)
    return drive.Outcome(
        e2e={"column_steps_per_s": 1.5e6, "call_ms_p95": 1.2,
             "setup_s": 20.0}, attempted=10, failed=0,
        memory_peak_bytes=123, checks={"worst_gap": (0.01, 0.1),
                                       "nonfinite": (0, 0)},
        where="a/qc", trace=summary if traced else None, control=None)


@pytest.mark.parametrize("name", ["mixed1.loop", "mixed1.wrf_calls"])
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_has_the_contract_keys(name, traced):
    cell = find_cell(name)
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
              "count": 1, "memory_peak_bytes": 123}
    line = json.loads(json.dumps(run.result_line(
        cell, fake_outcome(traced), traced, device)))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) == {m["name"] for m, _ in
                                        cell.per_layer}
    else:
        assert "breakdown" not in line
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert line["checks"]["worst_gap"] == {"value": 0.01, "limit": 0.1}


def test_a_failed_check_makes_the_line_incorrect():
    cell = find_cell("mixed1.loop")
    out = fake_outcome(False)._replace(
        checks={"worst_gap": (0.2, 0.1), "nonfinite": (0, 0)})
    assert not run.result_line(cell, out, False, {})["correct"]
    out = out._replace(checks={"worst_gap": (0.0, 0.1), "nonfinite": (3, 0)})
    assert not run.result_line(cell, out, False, {})["correct"]


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_counts_every_step_and_all_the_time_with_a_stall():
    clock = FakeClock()
    durations = iter([0.3, 0.3, 5.0, 0.3, 0.3, 0.3, 0.3])

    def step():
        clock.t += next(durations)
        return 150 * 8192

    work, elapsed, n = drive.timed_window(step, 6.0, clock)
    assert n == 5 and elapsed == pytest.approx(6.2)
    assert work == 5 * 150 * 8192
    assert work / elapsed == pytest.approx(5 * 150 * 8192 / 6.2)


def test_p95_is_over_every_call_of_the_window_with_a_stall():
    clock = FakeClock()
    lat = []
    calls = iter([1.0] * 95 + [40.0] * 5 + [1.0] * 50)

    def step():
        ms = next(calls)
        clock.t += ms / 1e3
        lat.append(ms)
        return 1

    k = drive.timed_window(step, 0.29, clock)[0]
    assert k == len(lat) == 100          # 0.095 s, then the stall
    assert drive.latency_p95(lat) > 30.0
    assert drive.latency_p95([1.0] * 100) == 1.0


def test_trace_reduction_unions_overlapping_activity():
    s = trace.summarize(
        [("void fused_step_kernel<float>", 0.0, 300.0),
         ("Memcpy DtoD (Device -> Device)", 100.0, 200.0),
         ("ncclDevKernel_SendRecv", 250.0, 450.0),
         ("void at::native::vectorized_elementwise_kernel<4>", 600.0,
          700.0)],
        [("kidbench.simulate", 0.0, 1000.0),
         ("cudaGraphLaunch", 440.0, 560.0)], units=4, window_s=1e-3)
    assert s.busy_s == pytest.approx(550e-6)
    assert s.by_class == pytest.approx({OWN: 300e-6, COPY: 100e-6,
                                        NCCL: 200e-6, TORCH: 100e-6})
    assert s.idle_gaps == [["cudaGraphLaunch", pytest.approx(150e-6)]]
    assert s.device_ops[0][0].startswith("void fused_step_kernel")


def test_kernel_classes_sort_the_recorded_trace_names():
    recorded = json.loads((DATA / "trace_names.json").read_text())
    for cls, names in recorded.items():
        for name in names:
            assert kernel_class(name) == cls, name
    own = recorded[OWN]
    assert any("fused_step_kernel" in n for n in own)
    assert any("table_stage_kernel" in n for n in own)
    assert kernel_class("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)") \
        == NCCL
    assert kernel_class("void my_new_triton_kernel_0d1d2d") == OWN


def test_the_gap_of_each_field_and_its_edge_cases():
    import numpy as np

    from kidbench import compare
    before = np.array([1.0, 2.0])
    ref = np.array([1.5, 2.5])
    assert compare.field_gap(before, ref, ref) == 0.0
    assert compare.field_gap(before, before, ref) == 1.0      # unchanged
    assert compare.field_gap(0.0, np.zeros(2), np.zeros(2)) == 0.0
    moved = compare.field_gap(np.ones(2), np.array([1.0, 1.0 + 1e-9]),
                              np.ones(2))
    assert moved == pytest.approx(1e-9 / (1e-4 * np.sqrt(2)))
    for bad in (np.array([np.nan, 0.0]), np.array([np.inf, 0.0])):
        g = compare.field_gap(before, bad, ref)
        assert g == compare.NONE_SUCH and json.loads(json.dumps(g)) == g
    assert compare.field_gap(0.0, np.ones(2), np.zeros(2)) == \
        compare.NONE_SUCH
    assert compare.worst({"a": {"qc": 0.1, "qr": 0.3}, "b": {"qc": 0.2}}) \
        == (0.3, "a/qr")


def test_the_ranks_traces_merge_and_the_collective_share():
    from kidbench.sharded import merge_traces
    from kidbench.manifest import HERE, reader
    parts = [trace.summarize(
        [("void fused_step_kernel<float>", 0.0, 300.0),
         ("ncclDevKernel_SendRecv", 300.0, 300.0 + nccl)], [], units=2,
        window_s=1e-3) for nccl in (10.0, 50.0)]
    merged = merge_traces(parts)
    assert merged.by_class[OWN] == pytest.approx(300e-6)
    assert merged.by_class[NCCL] == pytest.approx(30e-6)
    assert merged.busy_s == pytest.approx(330e-6)
    share = reader(HERE / "metrics" / "nccl_share.py")(merged, None)
    assert share == pytest.approx(100 * 30e-6 / 350e-6)
    assert reader(HERE / "metrics" / "nccl_share.py")(parts[0]._replace(
        per_rank=[{OWN: 1.0, TORCH: 0.0, COPY: 0.0, NCCL: 0.0}]), None) \
        is None
