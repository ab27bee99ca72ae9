"""Benchmark: column-steps/s of the real KiD cases on one card (the port's
counterpart of ``bench.py`` and of ``bench_scaling_r05.py::flagship_100k``).

    python -m kid_tpu_torch.bench                 # on the card
    python -m kid_tpu_torch.bench --device cpu    # small sizes, a smoke run

Prints ONE JSON line (``--record PATH`` also merges it into the JSON record
at PATH as its ``bench`` block, with where it ran). The primary metric
drives the mixed1 case through the whole driver step (advection, provisional
state, the table stage and ``fused_step``) widened to ``--ncol`` identical
columns (8192 on the card), timed over ``--steps`` steps (100) from a
spun-up state.  warm1, warm1_recon and aerosol1d are timed the same way;
then the synthetic mixed-phase solver batch (one ``batched_microphysics``
call a step, graphed on the card, and again eager) and the flagship,
cumulus2d widened to ``--flagship-nx`` columns (131072) at its 60 levels,
150 spin-up steps and 20 timed.

Protocol (``bench.py:43-78``): spin-up, one warm window, then the best of
2 timed windows that replay the warm window's steps (the flagship: one),
each ended by copying the whole state to the host; on the card CUDA
events around the same windows give the device-clock time too.  Every
number is float32 and names the device it ran on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from . import records
from .baseline import BASELINE_COL_STEPS_PER_SEC
from .config import MicroConfig
from .device import resolve_device
from .driver.cases import AEROSOL1D, CUMULUS2D, MIXED1, WARM1, WARM1_RECON
from .driver.loop import initial_state, simulate
from .micro import ColumnState, batched_microphysics
from .micro.solver import device_tables
from .tables.cache import get_tables

DTYPE = torch.float32
# card sizes; the CPU sizes are bench.py's smoke sizes
CARD = dict(ncol=8192, spin=250, steps=100, synthetic_steps=30,
            flagship_nx=131072, flagship_spin=150, flagship_steps=20)
CPU = dict(ncol=256, spin=4, steps=4, synthetic_steps=3, flagship_nx=64,
           flagship_spin=4, flagship_steps=4)


def _timed(dev, run):
    """``run()`` (returns a state) timed on the host clock, ended by a
    copy of the whole state to the host, and on the card by CUDA events
    too; returns (state, seconds, event ms or None)."""
    events = None
    if dev.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    st = run()
    if events:
        events[1].record()
    for t in st:
        t.cpu()
    seconds = time.perf_counter() - t0
    return st, seconds, events[0].elapsed_time(events[1]) if events else None


def case_throughput(case, ncol, n_spin, n_time, device="cuda", n_windows=2):
    """``case`` widened to ``ncol`` columns: spin-up, a warm window, then
    the best of ``n_windows`` timed windows of ``n_time`` steps.  Returns
    column-steps/s and ms/step (host clock; events on the card) of the
    best window."""
    dev = resolve_device(device)
    wide = dataclasses.replace(case, nx=ncol)
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), DTYPE, dev)
    st = initial_state(wide, DTYPE, dev)
    st, _ = simulate(st, tables, wide, n_spin, device=dev)
    st, _ = simulate(st, tables, wide, n_time, istep0=n_spin, device=dev)
    st.qv[0, 0].cpu()
    best = None
    for _ in range(n_windows):
        st, sec, ev = _timed(dev, lambda st=st: simulate(
            st, tables, wide, n_time, istep0=n_spin, device=dev)[0])
        if best is None or sec < best[0]:
            best = sec, ev
    out = {"column_steps_per_sec": ncol * n_time / best[0],
           "ms_per_step": best[0] / n_time * 1e3}
    if best[1] is not None:
        out["event_ms_per_step"] = best[1] / n_time
    return out, st


def example_batch(ncol, nz, dev, seed=0):
    """The reference bench's synthetic mixed-phase columns
    (``__graft_entry__._example_batch``): a standard-atmosphere sounding
    with cloud, rain, ice, snow and graupel layers, each column scaled by
    1 + 5% seeded noise; returns (state, pres, w, dzq)."""
    rng = np.random.default_rng(seed)
    zc = (np.arange(nz) + 0.5) * (12000.0 / nz)
    p = 101325.0 * np.exp(-zc / 8500.0)
    t = np.maximum(288.0 - 0.0065 * zc, 210.0)
    qv = 0.012 * np.exp(-zc / 2500.0)
    rho = 0.622 * p / (287.04 * t * (qv + 0.622))

    def b(x, scale=1.0):
        arr = np.broadcast_to(x, (ncol, nz)).copy()
        arr *= (1.0 + 0.05 * rng.standard_normal((ncol, 1)))
        return torch.tensor(np.maximum(arr * scale, 0.0), dtype=DTYPE,
                            device=dev)

    cloud = np.where((zc > 500) & (zc < 3000), 1.0e-3, 0.0)
    rain = np.where(zc < 2000, 3.0e-4, 0.0)
    ice = np.where(zc > 6000, 5.0e-5, 0.0)
    snow = np.where(zc > 5000, 2.0e-4, 0.0)
    state = ColumnState(
        t=b(t), qv=b(qv), qc=b(cloud), qi=b(ice), qr=b(rain),
        qs=b(snow), qg=b(snow, 0.5),
        ni=b(np.where(ice > 0, 1.0e4, 0.0)),
        nr=b(np.where(rain > 0, 1.0e5, 0.0)),
        nc=b(100.0e6 / rho), nwfa=b(11.1e6 / rho),
        nifa=b(0.5e4 / rho))
    pres = torch.tensor(p, dtype=DTYPE, device=dev).expand(ncol, nz)
    w = torch.zeros((ncol, nz), dtype=DTYPE, device=dev)
    dzq = torch.full((ncol, nz), 12000.0 / nz, dtype=DTYPE, device=dev)
    return state, pres, w, dzq


def synthetic_throughput(ncol, nz, steps, device="cuda", graphs=True):
    """The solver alone on the synthetic batch, one call a step (the
    reference bench's round-2/3 metric): column-steps/s.  The first call,
    untimed, captures the call as a CUDA graph on a card, as the
    reference's first call compiles it; ``graphs=False``: every call
    eager."""
    dev = resolve_device(device)
    cfg = MicroConfig(iiwarm=False)
    tables = device_tables(get_tables(iiwarm=False), DTYPE, dev)
    st, pres, w, dzq = example_batch(ncol, nz, dev)

    def step(s):
        return batched_microphysics(s, pres, w, dzq, 10.0, tables, cfg,
                                    want_rates=False, device=dev,
                                    graphs=graphs)[0]

    st = step(st)
    st.qr.cpu()
    t0 = time.perf_counter()
    for _ in range(steps):
        st = step(st)
    st.qr.cpu()
    return ncol * steps / (time.perf_counter() - t0)


def flagship(nx, n_spin, n_time, device="cuda"):
    """cumulus2d widened to ``nx`` columns at its 60 levels
    (``bench_scaling_r05.py:38``) as ``nx / 64`` copies of its
    circulation cell: spin-up, a warm window, one timed window.  (Widened
    as the reference widens it, the circulation stretches with the
    domain: at 131072 columns its u reaches 5684 m/s, an x-CFL number of
    114, and the run goes non-finite.)"""
    dev = resolve_device(device)
    case = dataclasses.replace(CUMULUS2D, cell_nx=CUMULUS2D.nx)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    r, _ = case_throughput(case, nx, n_spin, n_time, dev, n_windows=1)
    r = {"case": "cumulus2d", "nx": nx, "nz": case.nz,
         "cell_nx": case.cell_nx, "dtype": "float32",
         "n_steps_timed": n_time, **r}
    if dev.type == "cuda":
        r["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kid_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    for k in CARD:
        ap.add_argument(f"--{k.replace('_', '-')}", type=int, default=None,
                        help=f"(card {CARD[k]}, CPU {CPU[k]})")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="also merge the line into this JSON record as its "
                         "'bench' block")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    size = {k: (v if getattr(args, k) is None else getattr(args, k))
            for k, v in (CARD if dev.type == "cuda" else CPU).items()}
    ncol, spin, steps = size["ncol"], size["spin"], size["steps"]
    t0 = time.perf_counter()
    mixed, _ = case_throughput(MIXED1, ncol, spin, steps, dev)
    # dt = 1 s: twice the steps reach the same point of the pulse
    warm, _ = case_throughput(WARM1, ncol, 2 * spin, steps, dev)
    warm_recon, _ = case_throughput(WARM1_RECON, ncol, 2 * spin, steps, dev)
    aero, _ = case_throughput(AEROSOL1D, ncol, spin, steps, dev)
    synth = synthetic_throughput(ncol, 120, size["synthetic_steps"], dev)
    synth_eager = synthetic_throughput(ncol, 120, size["synthetic_steps"],
                                       dev, graphs=False)
    flag = flagship(size["flagship_nx"], size["flagship_spin"],
                    size["flagship_steps"], dev)
    value = mixed["column_steps_per_sec"]
    line = {
        "metric": "column_steps_per_sec_mixed1_case_nz120",
        "value": value, "unit": "column-steps/s/card",
        "vs_baseline": value / BASELINE_COL_STEPS_PER_SEC,
        "warm1_case": warm["column_steps_per_sec"],
        "warm1_recon_case": warm_recon["column_steps_per_sec"],
        "aerosol1d_case": aero["column_steps_per_sec"],
        "synthetic_mixed_phase_r03_metric": synth,
        "synthetic_mixed_phase_eager": synth_eager,
        "windows": {"mixed1": mixed, "warm1": warm,
                        "warm1_recon": warm_recon, "aerosol1d": aero},
        "flagship_2d": flag, "ncol": ncol, "spin_steps": spin,
        "timed_steps": steps, "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "seconds": time.perf_counter() - t0}
    if args.record:
        records.merge(args.record, {"bench": line}, dev)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
