"""Scaling of the sharded loop over cards, and what its exchange costs (the
port's counterpart of ``bench_scaling.py`` and ``bench_scaling_r05.py``).

    python -m kid_tpu_torch.scaling --ranks 1,2,4 --out SCALING_h100.json
    python -m kid_tpu_torch.scaling --device cpu --ranks 1,2    # gloo ranks

cumulus2d in float32, its 64-column circulation tiled (``Case.cell_nx``),
at 60 levels.  Every run starts from one spun-up state: 150 steps in one
process, then a warm window of 20 steps from step 150, whose end is the
state every run of that width starts from, timed over 20 steps that
replay the window's m(t), as
``bench.flagship`` times; the sizes are ``CARD``'s on a card and
``CPU``'s on the CPU.  The sections (the reference's names where the
thing is the same):

- ``flagship_100k_2d``: ``bench.flagship`` at 131072 columns.
- ``nccl_mesh`` (the reference's ``cpu_virtual_mesh_8dev``), each row on
  ranks of ``dist.launch.run_sharded``, each rank replaying a CUDA graph
  of its step with the halo exchange in it, after ``WARMUP`` discarded
  steps (its capture among them):
  - collective overhead: the flagship in one process (``single_dev_s``,
    ``simulate``) against the same global problem on N ranks
    (``sharded_s``: the slowest rank's seconds), ``sharded_s /
    single_dev_s - 1`` as the reference computes it; with a card a rank
    that is N times less work, so ``collective_overhead_per_card``
    (``N * sharded_s / single_dev_s - 1``) is the exchange's and the
    ranks' own cost;
  - weak scaling: 32768 columns a rank (512 cells),
    so the global width is N times that; ms/step a rank, column-steps/s
    over all ranks, efficiency t(1) / t(N);
  - strong scaling: the flagship on N ranks, efficiency t(1) / (N t(N)).
  Every row's finals and precip series must equal the one-process run of
  the same width bit for bit (a run of a width and rank count is made
  once and serves every section that needs it).
- ``exchange_in_graph`` (the counterpart of the reference's AOT
  schedule, ``tpu_8chip_aot_compile``): each multi-rank flagship run's
  profiled window (``launch.profiled_window``, ``PROFILED`` steps after
  the timed ones, opened after a barrier): on the last rank to enter it,
  the NCCL kernels a step and their share of the rank's device time, and
  the host calls of the exchange a step between replays (0: the graph
  holds it).
- ``targets``: ``throughput_vs_baseline_10x`` from the bench's record
  (``BENCH_h100.json``, if there is one, with that run's commit, source
  digest and time), ``scaling_85pct`` from the 2-rank weak and strong
  efficiencies: cards of one host, not two hosts.

On a card, a row of N > 1 ranks needs N cards under NCCL: ranks that
share a card time-slice it and measure no scaling, so such a layout is
refused before anything runs (exit 2).  Without a card it exits 2 unless
``--device cpu``, where every rank is a gloo process on the CPU, eager.
Prints one JSON line a row and the report; ``--out`` writes the report
with where it ran (``records.write``).  A script that calls ``main``
needs an ``if __name__ == "__main__"`` guard (the ranks are spawned).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import bench, records
from .device import resolve_device
from .dist import launch
from .driver.cases import CUMULUS2D
from .driver.loop import BLOCKS, KidState, initial_state, simulate
from .micro.solver import device_tables
from .tables.cache import get_tables

DTYPE = torch.float32
CARD = dict(per_rank_nx=32768, flagship_nx=131072, spin=150, steps=20)
CPU = dict(per_rank_nx=128, flagship_nx=256, spin=2, steps=4)
WARMUP = 3            # steps a rank runs first and discards
PROFILED = 5          # steps of each rank's profiled window
BENCH_RECORD = Path(__file__).resolve().parents[1] / "BENCH_h100.json"
PPT = ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice")


def tiled(nx: int):
    """cumulus2d at ``nx`` columns, its 64-column cell repeated."""
    return dataclasses.replace(CUMULUS2D, nx=nx, cell_nx=CUMULUS2D.nx)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def one_process(nx: int, n_spin: int, n_time: int, device) -> dict:
    """``tiled(nx)`` in this process through ``simulate`` (graphed on a
    card): spin-up, the warm window, then the timed window from the warm
    window's end.  Returns numpy: ``state0`` (the timed window's start),
    ``fields`` and ``ppt`` (its end and its precip series), and its host
    ``seconds`` and ``ms_per_step``."""
    dev = resolve_device(device)
    case = tiled(nx)
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), DTYPE, dev)
    st = initial_state(case, DTYPE, dev)
    st, _ = simulate(st, tables, case, n_spin, device=dev)
    st, _ = simulate(st, tables, case, n_time, istep0=n_spin, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    final, out = simulate(st, tables, case, n_time, istep0=n_spin,
                          device=dev)
    _sync(dev)
    seconds = time.perf_counter() - t0
    return dict(state0=np.stack([t.cpu().numpy() for t in st]),
                fields={f: getattr(final, f).cpu().numpy()
                        for f in KidState._fields},
                ppt={k: getattr(out, k).cpu().numpy() for k in PPT},
                seconds=seconds, ms_per_step=seconds * 1e3 / n_time)


def same_bits(one: dict, run) -> bool:
    """A ``ShardedRun``'s finals and precip series equal ``one``'s."""
    return (all(np.array_equal(one["fields"][f], run.fields[f])
                for f in KidState._fields)
            and all(np.array_equal(one["ppt"][k], run.ppt[k]) for k in PPT))


def sharded_row(one: dict, nx: int, n: int, size: dict, layout) -> dict:
    """``tiled(nx)`` on ``n`` ranks of ``layout`` (devices, backend) from
    ``one``'s ``state0``, ``size["steps"]`` steps from step
    ``size["spin"]``, with a profiled window: the slowest rank's seconds
    and ms/step, column-steps/s over all ranks, each rank's numbers, and
    whether the bits are ``one``'s."""
    devices, backend = layout
    run = launch.run_sharded(
        tiled(nx), n, size["steps"], DTYPE, devices, backend,
        istep0=size["spin"], state0=one["state0"], warmup_steps=WARMUP,
        profile_steps=PROFILED)
    seconds = max(r["seconds"] for r in run.ranks)
    return {
        "ranks": n, "nx": nx, "nx_per_rank": nx // n, "backend": backend,
        "devices": devices, "sharded_s": seconds,
        "ms_per_step": max(r["ms_per_step"] for r in run.ranks),
        "column_steps_per_sec": nx * size["steps"] / seconds,
        "bitwise_equal_to_one_process": same_bits(one, run),
        "rank_ms_per_step": [r["ms_per_step"] for r in run.ranks],
        "placement": [r["placement"] for r in run.ranks],
        "exchange_calls": [r["exchange_calls"] for r in run.ranks],
        "launches": [r["launches"] for r in run.ranks],
        "capture_ms": [r["capture_ms"] for r in run.ranks],
        "peak_gib": [None if r["peak_bytes"] is None
                     else r["peak_bytes"] / 2**30 for r in run.ranks],
        "profile": [r["profile"] for r in run.ranks]}


def collective_overhead(single_s: float, sharded_s: dict) -> dict:
    """{N: sharded_s[N] / single_s - 1} (the reference's formula)."""
    return {n: s / single_s - 1.0 for n, s in sharded_s.items()}


def per_card_overhead(single_s: float, sharded_s: dict) -> dict:
    """{N: N * sharded_s[N] / single_s - 1}: the card-seconds N ranks
    spend on the problem against one card's."""
    return {n: int(n) * s / single_s - 1.0 for n, s in sharded_s.items()}


def weak_efficiency(ms: dict) -> dict:
    """{N: t(1) / t(N)} of ms/step at a fixed width a rank."""
    return {n: ms["1"] / t for n, t in ms.items()}


def strong_efficiency(ms: dict) -> dict:
    """{N: t(1) / (N t(N))} of ms/step at a fixed global width."""
    return {n: ms["1"] / (int(n) * t) for n, t in ms.items()}


def exchange_in_graph(row: dict) -> dict:
    """The profiled window of ``row`` on its last rank to enter it: NCCL
    kernels and host calls of the exchange a step, their device ms and
    share; and every rank's share."""
    profs = row["profile"]
    last = max(range(len(profs)), key=lambda r: profs[r]["entered_s"])
    p = profs[last]
    return {"ranks": row["ranks"], "nx": row["nx"], "last_rank": last,
            "profiled_steps": PROFILED,
            "nccl_kernels_per_step": p["nccl_kernels"],
            "exchange_device_ms_per_step": p["exchange_device_ms"],
            "device_ms_per_step": p["device_ms"],
            "exchange_device_share": p["exchange_device_share"],
            "host_exchange_calls_per_step": p["host_exchange_calls"],
            "every_rank_share": [q["exchange_device_share"] for q in profs],
            "window_entry_spread_ms": (max(q["entered_s"] for q in profs)
                                       - min(q["entered_s"] for q in profs))
            * 1e3}


def targets(weak: dict, strong: dict, bench_record: Path, device) -> dict:
    """The reference's two targets, as far as this run can speak to
    them: the throughput one from the bench's record at
    ``bench_record``, if there is one, with the bench run's commit,
    source digest and time (another run than this one)."""
    out = {"scaling_85pct": {
        "weak_2": weak.get("2"), "strong_2": strong.get("2"),
        "met_on_cards_of_one_host": (None if "2" not in weak else
                                     weak["2"] >= 0.85
                                     and strong["2"] >= 0.85),
        "note": ("cards of one host (NVLink) were measured; two hosts "
                 "were not" if device.type == "cuda" else
                 "gloo ranks on the CPU: not a measurement of cards")}}
    if bench_record.exists():
        record = json.loads(bench_record.read_text())
        line, prov = record["bench"], record.get("runs", {}).get("bench", {})
        out["throughput_vs_baseline_10x"] = {
            "vs_baseline": line["vs_baseline"],
            "met": line["vs_baseline"] >= 10.0,
            "source": f"{bench_record.name}: the bench line's vs_baseline",
            **{k: prov.get(k) for k in ("commit", "source_sha256", "at")}}
    else:
        out["throughput_vs_baseline_10x"] = "not measured in this run"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kid_tpu_torch.scaling",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--ranks", default="1,2,4",
                    help="comma-separated rank counts (default 1,2,4)")
    ap.add_argument("--out", default=None, help="JSON record path")
    args = ap.parse_args(argv)
    ranks = [int(k) for k in args.ranks.split(",") if k]
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"scaling: {e}", file=sys.stderr)
        return 2
    layouts = {n: launch.default_layout(n, dev) for n in ranks}
    shared = [n for n, (_, backend) in layouts.items()
              if dev.type == "cuda" and n > 1 and backend != "nccl"]
    if shared:
        print(f"scaling: {torch.cuda.device_count()} CUDA card(s) found; "
              f"{shared} ranks would share a card and time-slice it, which "
              f"measures no scaling: a row of N ranks needs N cards",
              file=sys.stderr)
        return 2
    size = CARD if dev.type == "cuda" else CPU
    t_start = time.perf_counter()
    flag_nx, per_rank = size["flagship_nx"], size["per_rank_nx"]
    report = {"flagship_100k_2d": bench.flagship(
        flag_nx, size["spin"], size["steps"], dev)}
    widths = sorted({flag_nx, *(n * per_rank for n in ranks)})
    ones = {nx: one_process(nx, size["spin"], size["steps"], dev)
            for nx in widths}
    BLOCKS.clear()                 # the ranks get the card's memory
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rows = {}

    def row(nx, n):
        if (nx, n) not in rows:
            rows[nx, n] = sharded_row(ones[nx], nx, n, size, layouts[n])
            print(json.dumps({k: v for k, v in rows[nx, n].items()
                              if k != "profile"}), flush=True)
        return rows[nx, n]

    strong = {str(n): row(flag_nx, n) for n in ranks}
    weak = {str(n): row(n * per_rank, n) for n in ranks}
    single_s = ones[flag_nx]["seconds"]
    sharded_s = {n: r["sharded_s"] for n, r in strong.items()}
    weak_eff = weak_efficiency({n: r["ms_per_step"] for n, r in weak.items()})
    strong_eff = strong_efficiency({n: r["ms_per_step"]
                                    for n, r in strong.items()})
    report["nccl_mesh"] = {
        "case": "cumulus2d (64-column cell tiled), f32, 60 levels",
        "steps_timed": size["steps"], "from_step": size["spin"],
        "single_dev_s": single_s,
        "single_dev_ms_per_step": ones[flag_nx]["ms_per_step"],
        "sharded_s": sharded_s,
        "collective_overhead": collective_overhead(single_s, sharded_s),
        "collective_overhead_per_card": per_card_overhead(single_s,
                                                          sharded_s),
        "bitwise_equal": all(r["bitwise_equal_to_one_process"]
                             for r in rows.values()),
        "weak_scaling": {"nx_per_rank": per_rank, "rows": weak,
                         "efficiency": weak_eff},
        "weak_scaling_s_per_mesh": {n: r["sharded_s"]
                                    for n, r in weak.items()},
        "strong_scaling": {"nx": flag_nx, "rows": strong,
                           "efficiency": strong_eff},
        "note": ("each rank on a card of its own under NCCL, its step "
                 "(the halo exchange first) replayed as a CUDA graph"
                 if dev.type == "cuda" else
                 "gloo ranks on the CPU, eager: no device measurement")}
    report["exchange_in_graph"] = {
        n: exchange_in_graph(r) for n, r in strong.items() if int(n) > 1}
    report["targets"] = targets(weak_eff, strong_eff, BENCH_RECORD, dev)
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        report = records.write(args.out, report, dev)
    print(json.dumps({"bitwise_equal": report["nccl_mesh"]["bitwise_equal"],
                      "weak_efficiency": weak_eff,
                      "strong_efficiency": strong_eff,
                      "seconds": report["seconds"]}))
    return 0 if report["nccl_mesh"]["bitwise_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
