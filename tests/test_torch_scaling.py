"""The port's scaling record (``kid_tpu_torch/scaling.py``) on the CPU.

gloo ranks on the CPU at 128 columns a rank (2 cells of 64) x 60 levels,
N = 1 and 2, 4 timed steps after 2 spin-up steps: every row bit for bit
the one-process run of its width, the weak rows' global width N times a
rank's, the report's sections and keys those of the reference's
``SCALING_r05.json`` where the thing is the same.  The efficiency and
overhead arithmetic on fixed numbers.  On a card a row of more than one
rank without a card each (not NCCL) is refused before anything runs.
"""
from __future__ import annotations

import json

import pytest
import torch

from kid_tpu_torch import scaling as SC

torch.set_num_threads(2)


def test_scaling_rows_on_cpu_ranks(tmp_path, monkeypatch):
    out, bench = tmp_path / "s.json", tmp_path / "b.json"
    prov = {"commit": "abc", "source_sha256": "0f" * 32,
            "at": "2026-01-01T00:00:00+00:00"}
    bench.write_text(json.dumps({"bench": {"vs_baseline": 12.5},
                                 "runs": {"bench": {**prov, "argv": []}}}))
    monkeypatch.setattr(SC, "BENCH_RECORD", bench)
    assert SC.main(["--device", "cpu", "--ranks", "1,2", "--out",
                    str(out)]) == 0
    r = json.loads(out.read_text())
    assert {"flagship_100k_2d", "nccl_mesh", "exchange_in_graph", "targets",
            "hardware", "commit", "source_sha256"} <= set(r)
    per_rank, flag_nx = SC.CPU["per_rank_nx"], SC.CPU["flagship_nx"]
    f = r["flagship_100k_2d"]
    assert (f["nx"], f["nz"], f["cell_nx"]) == (flag_nx, 60, 64)
    mesh = r["nccl_mesh"]
    assert mesh["bitwise_equal"] is True
    for key in ("single_dev_s", "sharded_s", "collective_overhead",
                "collective_overhead_per_card", "weak_scaling",
                "weak_scaling_s_per_mesh", "strong_scaling"):
        assert key in mesh, key
    weak = mesh["weak_scaling"]["rows"]
    strong = mesh["strong_scaling"]["rows"]
    assert set(weak) == set(strong) == {"1", "2"}
    for n, row in weak.items():
        assert row["nx"] == int(n) * per_rank and row["ranks"] == int(n)
        assert row["nx_per_rank"] == per_rank
    for n, row in strong.items():
        assert row["nx"] == flag_nx
        assert row["nx_per_rank"] == flag_nx // int(n)
    # the 2-rank weak row is the 2-rank flagship row: made once
    assert weak["2"] == strong["2"]
    for row in (*weak.values(), *strong.values()):
        assert row["bitwise_equal_to_one_process"] is True
        assert row["backend"] == "gloo" and set(row["placement"]) == {"step"}
        assert row["exchange_calls"] == [SC.CPU["steps"]] * row["ranks"]
        assert row["column_steps_per_sec"] > 0
    assert mesh["weak_scaling"]["efficiency"]["1"] == 1.0
    assert mesh["collective_overhead"]["1"] == pytest.approx(
        strong["1"]["sharded_s"] / mesh["single_dev_s"] - 1.0)
    ex = r["exchange_in_graph"]
    assert set(ex) == {"2"}
    assert ex["2"]["host_exchange_calls_per_step"] == 1.0  # eager on the CPU
    assert ex["2"]["nccl_kernels_per_step"] == 0.0
    t = r["targets"]
    assert t["throughput_vs_baseline_10x"]["vs_baseline"] == 12.5
    assert t["throughput_vs_baseline_10x"]["met"] is True
    assert prov.items() <= t["throughput_vs_baseline_10x"].items()
    assert t["scaling_85pct"]["weak_2"] == mesh["weak_scaling"][
        "efficiency"]["2"]
    assert r["hardware"]["device"] == "cpu"


def test_efficiency_and_overhead_arithmetic():
    ms = {"1": 5.0, "2": 5.5, "4": 6.25}
    assert SC.weak_efficiency(ms) == {"1": 1.0, "2": 5.0 / 5.5, "4": 0.8}
    strong = {"1": 20.0, "2": 10.0, "4": 6.25}
    assert SC.strong_efficiency(strong) == {"1": 1.0, "2": 1.0, "4": 0.8}
    # SCALING_r05.json: 0.2637 / 0.374 - 1
    assert SC.collective_overhead(0.374, {"8": 0.2637})["8"] == \
        pytest.approx(-0.2949, abs=1e-4)
    assert SC.per_card_overhead(2.0, {"1": 2.0, "4": 0.6}) == \
        pytest.approx({"1": 0.0, "4": 0.2})


def test_exchange_in_graph_reads_the_last_rank_into_the_window():
    def prof(entered, share):
        return {"entered_s": entered, "nccl_kernels": 1.0,
                "exchange_device_ms": share, "device_ms": 1.0,
                "exchange_device_share": share, "host_exchange_calls": 0.0}

    row = {"ranks": 3, "nx": 96,
           "profile": [prof(10.0, 0.5), prof(10.002, 0.01), prof(9.0, 0.9)]}
    e = SC.exchange_in_graph(row)
    assert e["last_rank"] == 1 and e["exchange_device_share"] == 0.01
    assert e["every_rank_share"] == [0.5, 0.01, 0.9]
    assert e["window_entry_spread_ms"] == pytest.approx(1002.0)


def test_scaling_refuses_ranks_sharing_a_card(tmp_path, monkeypatch, capsys):
    out = tmp_path / "s.json"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert SC.main(["--ranks", "1,2", "--out", str(out)]) == 2
    assert "1 CUDA card(s) found" in capsys.readouterr().err
    assert not out.exists()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert SC.main(["--ranks", "1,2,4", "--out", str(out)]) == 2
    assert "2 CUDA card(s) found; [4] ranks" in capsys.readouterr().err
    assert not out.exists()


def test_scaling_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert SC.main([]) == 2
