"""The benchmark's command:

    python -m kidbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root, on a machine with the cards the cell asks for.
It loads, warms up the cell's shapes, measures for ``--seconds``, holds
the answers the window produced against the plain reference, and prints
one JSON line last on standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
profiled segment after the window.  The numbers compared, each with its
limit, are the last lines on standard error and the line's last key.
Without a card, or with fewer than the cell asks for, it exits 2 and
prints no result; with JAX or the JAX package loaded, in this process
or in a rank's, 3.  Every process the run started has ended, and has
been waited for, before it prints (``procs``).

``--control 1`` (not a run of the benchmark) also runs the control: the
reference with its state held in bfloat16, read by the same comparison,
reported under ``control``."""
from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "kidbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "kid_tpu")


def set_caches():
    """Every cache of the program and its libraries in fixed directories
    of the checkout (the kernels build into ``build/kid_tpu_torch/``; a
    Triton kernel or a torch extension would cache here too)."""
    os.environ["KID_TPU_TORCH_TABLE_CACHE"] = str(CACHE / "tables")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")


def loaded_forbidden() -> list:
    """Top-level module names of ``FORBIDDEN`` in ``sys.modules``, each
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell, out, trace: bool, device: dict) -> dict:
    """The last line: metrics by name with their units, the device, the
    breakdown of a traced run, and the checks last."""
    if trace:
        metrics = {}
        for m, read in cell.per_layer:
            v = read(out.trace, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device = {**device, "busy_s": out.trace.busy_s,
                  "window_s": out.trace.window_s}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    correct = all(v <= lim for v, lim in out.checks.values())
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = {"device_ops": out.trace.device_ops,
                             "idle_gaps": out.trace.idle_gaps}
    if out.control is not None:
        line["control"] = out.control
    line["worst_at"] = out.where
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kidbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    import torch

    from .drive import run_cell
    from .manifest import find_cell
    from .procs import Children

    if not torch.cuda.is_available():
        print("kidbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    cell = find_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"kidbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device("cuda:0")
    kids = Children()
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                       T_START, control=bool(args.control))
    finally:
        ended = kids.stop()
    if ended:
        print(f"kidbench: ended what the run left running: {ended}",
              file=sys.stderr)
    found = loaded_forbidden()
    if found:
        print(f"kidbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    if out.loaded_elsewhere:
        print(f"kidbench: loaded in a rank's process: "
              f"{list(out.loaded_elsewhere)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips, "memory_peak_bytes":
                  out.memory_peak_bytes}
    line = result_line(cell, out, bool(args.trace), device)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
