#!/usr/bin/env python3
"""Register budgets of the ``fused_step`` and ``fused_kid_step`` kernels,
measured side by side on one CUDA card.

    python3 kernel_budget.py [--reference DIR]... [--budget NAME=A,B,C,D]...
                             [--fmad]

Builds ``csrc/fused_step.cu`` and ``csrc/fused_kid_step.cu`` of
``kid_tpu_torch/micro`` as shipped, and once more per ``--budget``: the
``MIN_BLOCKS_*`` macros of ``csrc/thompson.cuh`` (blocks of 128 threads
that must fit on an SM) for float32 mixed, float32 warm, float64 mixed and
float64 warm.  Each ``--reference`` builds the same two files from another source
directory (for instance the ``csrc`` of an earlier commit), first, in
the order given.  ``--fmad`` adds a build of the shipped budget with
``-fmad=true``.  All builds run in parallel.  Then, on the card:

  * each build's registers, spill bytes, static shared bytes and active
    blocks per SM for every instantiation at nz 120 and 256;
  * every build's outputs against the first build's, bit for bit, on
    seeded batches (1000 columns; nz 33, 120 and 256; float32 and
    float64; mixed and warm; rate profiles on and off); the ``-fmad=true``
    build rounds otherwise, so its differing outputs are counted, not
    gated;
  * ms/launch of each build, in turns (first to last, then last to
    first), on mixed1's own inputs at (8192, 120) float32 after a
    150-step spin-up (``fused_step`` from the default step,
    ``fused_kid_step`` from the fused driver's), and on seeded warm and
    float64 batches at (8192, 120).

Imports the port (``kid_tpu_torch``) and ``chip_smoke`` only; builds into
``build/kid_tpu_torch/budget/`` at the repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as C
from kid_tpu_torch.micro import cuda_build

STEMS = ("fused_step", "fused_kid_step")
BUDGET_MACROS = ("MIN_BLOCKS_F32_MIXED", "MIN_BLOCKS_F32_WARM",
                 "MIN_BLOCKS_F64_MIXED", "MIN_BLOCKS_F64_WARM")
OUT = Path(__file__).resolve().parent / "build" / "kid_tpu_torch" / "budget"


def build_all(builds):
    """Compile every (name, source dir, macros, flags) build's two files
    in parallel; returns {name: {stem: CDLL}}."""
    header = cuda_build.constants_header()
    procs = []
    for name, src, macros, flags in builds:
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "kid_constants.h").write_text(header)
        for stem in STEMS:
            cmd = [cuda_build._nvcc(), *flags,
                   *[f"-D{k}={v}" for k, v in macros.items()],
                   "-I", str(out), "-I", str(src),
                   "-o", str(out / f"lib{stem}.so"), str(src / f"{stem}.cu")]
            procs.append((name, stem, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, stem, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {stem}.cu:\n{log}")
    return {name: {stem: ctypes.CDLL(str(OUT / name / f"lib{stem}.so"))
                   for stem in STEMS} for name, *_ in builds}


def using(libs):
    """Route the wrappers' launches to the libraries ``libs``."""
    def kernel_function(stem, dtype, argtypes):
        suffix = "f32" if dtype == torch.float32 else "f64"
        fn = getattr(libs[stem], f"kid_{stem}_{suffix}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn
    cuda_build.kernel_function = kernel_function


def resources(lib, stem, nz, dtype, warm, want_rates):
    fn = getattr(lib, f"kid_{stem}_resources")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    row = (ctypes.c_int * 4)()
    err = fn(nz, int(dtype == torch.float64), int(warm), int(want_rates),
             ctypes.addressof(row))
    if err != 0:
        raise RuntimeError(f"{stem} resources: cudaError {err}")
    return tuple(row)


def batches(dev):
    """Seeded inputs of both kernels: [(label, stem, launch)] where
    ``launch()`` runs the routed kernel and returns its outputs."""
    import kid_tpu_torch.micro.fused_kid_step as FK
    import kid_tpu_torch.micro.fused_step as F
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.driver.cases import MIXED1, WARM1_RECON
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.tables.cache import get_tables
    out = []
    for nz in (33, 120, 256):
        for dtype in (torch.float32, torch.float64):
            for warm in (False, True):
                cfg = MicroConfig(iiwarm=warm)
                tables = S.device_tables(get_tables(iiwarm=warm), dtype, dev)
                st, pres, dzq = C.make_batch(C.BATCH_NCOL, nz, 0, dtype, dev)
                pro, idx = S._prologue(st, pres, cfg)
                tv = S._table_stage(pro, idx, tables, cfg, 10.0)
                x = F.pack_inputs(st, pres, dzq, tv, cfg)
                case = dataclasses.replace(WARM1_RECON if warm else MIXED1,
                                           nx=C.BATCH_NCOL, nz=nz)
                kst, m, ktv, rows = C.kid_step_inputs(case, dtype, dev)
                kx, prof = FK.pack_kid_inputs(kst, ktv, *rows, case.micro)
                for rates in (False, True):
                    label = (f"nz={nz} {str(dtype)[6:]} "
                             f"{'warm ' if warm else 'mixed'} "
                             f"rates={int(rates)}")
                    out.append((label, "fused_step",
                                lambda x=x, cfg=cfg, r=rates:
                                F.launch_packed(x, cfg, 10.0, r)))
                    out.append((label, "fused_kid_step",
                                lambda x=kx, p=prof, m=m, c=case, r=rates:
                                FK.launch_kid_packed(x, p, m, c.micro, c.dt,
                                                     r)))
    return out


def timed_inputs(dev):
    """[(label, stem, launch)] at (8192, 120): mixed1's own inputs after
    the spin-up (float32), then seeded warm and float64 batches."""
    import kid_tpu_torch.micro.fused_kid_step as FK
    import kid_tpu_torch.micro.fused_step as F
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.driver.cases import MIXED1
    from kid_tpu_torch.driver.loop import FUSED_DRIVER_ENV, run_case, simulate
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.tables.cache import get_tables
    case = dataclasses.replace(MIXED1, nx=C.MAIN_NX)
    f32 = torch.float32
    st, _ = run_case(case, f32, n_steps=C.N_SPIN, device=dev)
    tables = S.device_tables(get_tables(iiwarm=False), f32, dev)
    last = {}
    for mod, name in ((F, "pack_inputs"), (FK, "pack_kid_inputs")):
        def recording(*args, _fn=getattr(mod, name), _name=name):
            last[_name] = _fn(*args)
            return last[_name]
        setattr(mod, name, recording)
    simulate(st, tables, case, 1, istep0=C.N_SPIN, device=dev)
    os.environ[FUSED_DRIVER_ENV] = "1"
    try:
        simulate(st, tables, case, 1, istep0=C.N_SPIN, device=dev)
    finally:
        del os.environ[FUSED_DRIVER_ENV]
    x = last["pack_inputs"]
    kx, prof = last["pack_kid_inputs"]
    m = case.time_modulation(C.N_SPIN * case.dt)
    out = [("mixed1 (8192, 120) f32", "fused_step",
            lambda: F.launch_packed(x, case.micro, case.dt, False)),
           ("mixed1 (8192, 120) f32", "fused_kid_step",
            lambda: FK.launch_kid_packed(kx, prof, m, case.micro, case.dt,
                                         False))]
    for dtype, warm in ((f32, True), (torch.float64, False),
                        (torch.float64, True)):
        cfg = MicroConfig(iiwarm=warm)
        tabs = S.device_tables(get_tables(iiwarm=warm), dtype, dev)
        b, pres, dzq = C.make_batch(C.MAIN_NX, 120, 0, dtype, dev)
        pro, idx = S._prologue(b, pres, cfg)
        tv = S._table_stage(pro, idx, tabs, cfg, 10.0)
        xb = F.pack_inputs(b, pres, dzq, tv, cfg)
        out.append((f"seeded (8192, 120) {str(dtype)[6:]} "
                    f"{'warm' if warm else 'mixed'}", "fused_step",
                    lambda xb=xb, cfg=cfg: F.launch_packed(xb, cfg, 10.0,
                                                           False)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reference", type=Path, action="append", default=[],
                    help="another csrc directory, built first")
    ap.add_argument("--budget", action="append", default=[],
                    metavar="NAME=A,B,C,D",
                    help="blocks of 128 threads per SM for f32 mixed, f32 "
                         "warm, f64 mixed, f64 warm")
    ap.add_argument("--fmad", action="store_true",
                    help="add the shipped budget built with -fmad=true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_budget: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = C.card_line()
    print(f"card: {card}", flush=True)
    flags = list(cuda_build.NVCC_FLAGS)
    builds = [(d.resolve().name, d.resolve(), {}, flags)
              for d in args.reference]
    builds.append(("shipped", cuda_build.SRC_DIR, {}, flags))
    for spec in args.budget:
        name, values = spec.split("=")
        macros = dict(zip(BUDGET_MACROS, map(int, values.split(","))))
        builds.append((name, cuda_build.SRC_DIR, macros, flags))
    if args.fmad:
        builds.append(("shipped-fmad", cuda_build.SRC_DIR, {},
                       [f if f != "-fmad=false" else "-fmad=true"
                        for f in flags]))
    libs = build_all(builds)
    names = [b[0] for b in builds]
    print(f"built {', '.join(names)}", flush=True)

    for name in names:
        for stem in STEMS:
            for nz in (120, 256):
                for dtype in (torch.float32, torch.float64):
                    for warm in (False, True):
                        for rates in (False, True):
                            r = resources(libs[name][stem], stem, nz, dtype,
                                          warm, rates)
                            print(f"resources {name} {stem} nz={nz} "
                                  f"{str(dtype)[6:]} "
                                  f"{'warm ' if warm else 'mixed'} "
                                  f"rates={int(rates)}: {r[0]} regs, "
                                  f"{r[1]} spill bytes, {r[2]} static "
                                  f"shared bytes, {r[3]} blocks/SM",
                                  flush=True)

    # bit for bit against the first build
    n_same, fmad_differ, n_batches = 0, 0, 0
    for label, stem, launch in batches(dev):
        using(libs[names[0]])
        want = launch()
        n_batches += 1
        for name in names[1:]:
            using(libs[name])
            got = launch()
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(got, want))
            if name == "shipped-fmad":
                fmad_differ += not same
            elif not same:
                raise AssertionError(f"{name} {stem} {label}: outputs "
                                     f"differ from {names[0]}")
            else:
                n_same += 1
    print(f"bit for bit: {n_same} (build, kernel, batch) outputs equal to "
          f"{names[0]}'s", flush=True)
    if args.fmad:
        print(f"-fmad=true: {fmad_differ} of {n_batches} (kernel, batch) "
              f"outputs differ from {names[0]}'s", flush=True)

    using(libs[names[0]])
    inputs = timed_inputs(dev)
    times = {}
    for order in (names, names[::-1]):
        for name in order:
            using(libs[name])
            for label, stem, launch in inputs:
                times.setdefault((label, stem, name), []).append(
                    C.time_ms(launch, 50))
    for label, stem, _ in inputs:
        row = ", ".join(
            f"{n} {' '.join(f'{t:.4f}' for t in times[(label, stem, n)])}"
            for n in names)
        print(f"ms/launch {stem} {label}: {row} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
