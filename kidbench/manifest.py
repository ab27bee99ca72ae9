"""Finds everything of a cell by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file (``traffic/<traffic>.json``), its
limits (``limits/<cell>.json``) and the reader of each of its per-layer
metrics (``metrics/<metric>.py``, a ``read(trace, cell)`` that returns
the number or None; where there is no such file, the reader of the
metric's family, ``metrics/<family>.py`` for ``<family>.<part>``, as
``kernel_roofline.py`` reads ``kernel_roofline.loop`` and
``kernel_roofline.calls``).  A cell, a mix or a metric is added by
adding files and entries, with no edit here."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    cfg: dict                 # the configuration file
    traffic: dict             # the traffic file
    limits: dict              # the comparison's limits
    end_to_end: list          # the manifest's end-to-end metrics it reports
    per_layer: list           # [(the manifest's metric, its reader)]


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(path: Path):
    """The ``read`` function of a metric file, loaded by path (a metric's
    name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"kidbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_file(metrics: Path, name: str) -> Path:
    """The reader of metric ``name``: ``<name>.py``, else the family's
    ``<family>.py`` for a name ``<family>.<part>``."""
    own = metrics / f"{name}.py"
    if own.exists() or "." not in name:
        return own
    return metrics / f"{name.rsplit('.', 1)[0]}.py"


def find_cell(name: str, root: Path = HERE.parent) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; ``root`` is the
    checkout's root, which holds the benchmark's folder ``kidbench``."""
    manifest = load(root / "BENCHMARK.json")
    bench = root / HERE.name
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(
        name=name, chips=int(w["chips"]), cfg=load(root / conf["file"]),
        traffic=load(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load(bench / "limits" / f"{name}.json"), end_to_end=e2e,
        per_layer=[(m, reader(metric_file(bench / "metrics", m["name"])))
                   for m in layer])
