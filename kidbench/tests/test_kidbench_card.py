"""On the card, at each cell's own size: a run of the benchmark with the
control reads ``correct`` true and the control above the limit.

    python3 -m pytest kidbench/tests/test_kidbench_card.py

Skips without an NVIDIA card (a cell on more cards, without as many)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from kidbench.manifest import find_cell, load

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in load(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 5 * 10 ** 9 + 3,
                                  7 * 10 ** 9 + 1])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(card, name, seed):
    import torch
    cell = find_cell(name)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{name} needs {cell.chips} cards")
    run = subprocess.run(
        [sys.executable, "-m", "kidbench", "--workload", name, "--seed",
         str(seed), "--seconds", "2", "--trace", "0", "--control", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert run.returncode == 0, run.stderr[-2000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    limit = line["checks"]["worst_gap"]["limit"]
    assert line["correct"], line["checks"]
    assert line["control"]["worst_gap"] > limit
