"""BENCHMARK.json and every file it names load; a cell added as files
and entries only, in a copy of the checkout, is found with no edit."""
import json
import re
import shutil
from pathlib import Path

import pytest

from kidbench.manifest import HERE, find_cell, load, metric_file

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = load(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_has_exactly_the_contract_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["kidbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [m["name"] for m in MANIFEST["end_to_end"]
             + MANIFEST["per_layer"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    names += [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


@pytest.mark.parametrize("name", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_and_its_files_load(name):
    cell = find_cell(name)
    assert cell.cfg["name"] in {c["name"] for c in MANIFEST["configs"]}
    assert {"bytes", "ops", "how"} <= set(cell.cfg["work"])
    assert cell.traffic["driver"] in ("case_loop", "call_loop")
    assert cell.limits["worst_gap"] > 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m, read in cell.per_layer:
        assert m["moves"] in e2e and callable(read)


def test_a_cell_added_as_files_only_is_found(tmp_path):
    shutil.copytree(ROOT / "kidbench", tmp_path / "kidbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "kidbench"
    cfg = json.loads((bench / "configs" / "mixed1_8192x120.json")
                     .read_text())
    cfg["name"] = "mixed1_wide"
    (bench / "configs" / "mixed1_wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "loop.json").read_text())
    traffic["chunk_steps"] = 50
    (bench / "traffic" / "short_calls.json").write_text(json.dumps(traffic))
    (bench / "limits" / "wide.short.json").write_text('{"worst_gap": 1}')
    (bench / "metrics" / "launches.short.py").write_text(
        "def read(trace, cell):\n    return 7.0\n")
    manifest["configs"].append(
        {"name": "mixed1_wide", "source": "a paper", "reduced": [],
         "file": "kidbench/configs/mixed1_wide.json", "why": "a test"})
    manifest["workloads"].append(
        {"name": "wide.short", "config": "mixed1_wide",
         "traffic": "short_calls", "chips": 1, "why": "a test"})
    manifest["per_layer"].append(
        {"name": "launches.short", "unit": "1/step", "better": "lower",
         "source": "program_counter", "layer": "kernels",
         "moves": "setup_s", "workloads": ["wide.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = find_cell("wide.short", root=tmp_path)
    assert cell.cfg["name"] == "mixed1_wide"
    assert cell.traffic["chunk_steps"] == 50
    assert [m["name"] for m, _ in cell.per_layer] == ["launches.short"]
    assert cell.per_layer[0][1](None, cell) == 7.0
    with pytest.raises(KeyError):
        find_cell("no.such", root=tmp_path)


@pytest.mark.parametrize("name, file", [
    ("kernel_roofline.loop", "kernel_roofline.py"),
    ("kernel_roofline.calls", "kernel_roofline.py"),
    ("device_idle.calls", "device_idle.py"),
    ("nccl_share", "nccl_share.py"),
    ("outside_kernels_ms.any.part", "outside_kernels_ms.any.py")])
def test_a_metric_is_read_by_its_own_file_or_its_family(name, file):
    assert metric_file(HERE / "metrics", name).name == file


def test_a_file_of_its_own_comes_before_the_family(tmp_path):
    (tmp_path / "kernel_roofline.py").write_text("")
    (tmp_path / "kernel_roofline.calls.py").write_text("")
    assert metric_file(tmp_path, "kernel_roofline.calls").name == (
        "kernel_roofline.calls.py")
    assert metric_file(tmp_path, "kernel_roofline.loop").name == (
        "kernel_roofline.py")
