"""Command-line entry: run KiD cases end-to-end from a shell (the port's
counterpart of ``python -m kid_tpu``).

    python -m kid_tpu_torch list
    python -m kid_tpu_torch run warm1 --out diags.nc
    python -m kid_tpu_torch run mixed1 --steps 300 --dtype f32 --ncol 128 \\
        --out diags.npz --profiles qc,qr,prr_wau
    python -m kid_tpu_torch run warm1_recon --device cpu --steps 12
    python -m kid_tpu_torch run cumulus2d --device cpu --steps 3

``run`` integrates the full pipeline: case setup (driver/cases.py), table
build/cache, the time loop (driver/loop.py), the save_dg diagnostics
registry (diag/registry.py) and its npz / classic-NetCDF sinks, and
optional checkpointing (utils/checkpoint.py).  It runs on the card unless
``--device cpu`` is given; with KID_TPU_TORCH_FUSED_DRIVER=1 in the
environment a 1-D non-aerosol case goes through the fused driver step.
``--ncol`` widens 1-D cases only: a 2-D case's width sets its circulation.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def _run(args) -> int:
    import torch

    from .device import resolve_device
    from .diag.registry import registry_from_run
    from .driver.cases import CASES, PROVENANCE
    from .driver.loop import ALL_PROFILE_NAMES, initial_state, simulate
    from .micro.solver import device_tables
    from .tables.cache import get_tables

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    case = CASES[args.case]
    if args.ncol and case.nx == 1:
        case = dataclasses.replace(case, nx=args.ncol)
    n_steps = args.steps or case.n_steps
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    profiles = (tuple(args.profiles.split(","))
                if args.profiles else ALL_PROFILE_NAMES)

    print(f"case {case.name} ({PROVENANCE.get(case.name, 'n/a')})")
    print(f"  nx={case.nx} nz={case.nz} dt={case.dt}s steps={n_steps} "
          f"dtype={args.dtype} device={dev}")
    if dev.type == "cuda":
        print(f"  card: {torch.cuda.get_device_name(dev)}")
    t0 = time.time()
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype, dev)
    state = initial_state(case, dtype, dev)

    ckpt = None
    istep0 = 0
    if args.checkpoint_dir:
        from .utils.checkpoint import RunCheckpointer
        ckpt = RunCheckpointer(args.checkpoint_dir, case.name)
        if args.resume:
            restored = ckpt.restore(device=dev)
            if restored is not None:
                istep0, state = restored
                state = type(state)(*[x.to(dtype) for x in state])
                print(f"  resumed from checkpoint step {istep0}")

    final, streams = simulate(state, tables, case, n_steps - istep0,
                              profile_diags=profiles, istep0=istep0,
                              device=dev)
    total = float(streams.ppt_rain.double().sum())
    wall = time.time() - t0
    print(f"  done in {wall:.1f}s "
          f"({case.nx * (n_steps - istep0) / wall:,.0f} col-steps/s); "
          f"accumulated surface rain {total:.4g} kg/m^2 x cols")
    if ckpt is not None:
        ckpt.save(n_steps, final)
        print(f"  checkpoint written at step {n_steps}")

    if args.out:
        reg = registry_from_run(case.name, streams, case.nx)
        if args.out.endswith((".nc", ".cdf")):
            reg.to_netcdf(args.out)
        else:
            reg.to_npz(args.out)
        print(f"  diagnostics ({len(reg.names())} streams) -> {args.out}")
    return 0


def _list(_args) -> int:
    from .driver.cases import CASES, PROVENANCE
    for name, case in CASES.items():
        mode = ("aerosol-aware" if case.micro.is_aerosol_aware
                else "warm-only" if case.micro.iiwarm else "mixed-phase")
        print(f"{name:14s} nx={case.nx:<4d} nz={case.nz:<4d} "
              f"dt={case.dt:<4g} t_final={case.t_final:<7g} {mode}")
        print(f"{'':14s}   {PROVENANCE.get(name, '')}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m kid_tpu_torch",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pl = sub.add_parser("list", help="list cases with provenance")
    pl.set_defaults(fn=_list)
    pr = sub.add_parser("run", help="run a case end-to-end")
    pr.add_argument("case")
    pr.add_argument("--steps", type=int, default=0,
                    help="override step count (default: full case)")
    pr.add_argument("--ncol", type=int, default=0,
                    help="widen a 1-D case to N identical columns")
    pr.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    pr.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    pr.add_argument("--profiles", default="",
                    help="comma list of diagnostic streams "
                         "(default: all)")
    pr.add_argument("--out", default="",
                    help="diagnostics sink: *.nc (classic NetCDF) or "
                         "*.npz")
    pr.add_argument("--checkpoint-dir", default="")
    pr.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir")
    pr.set_defaults(fn=_run)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
