#!/usr/bin/env python3
"""Register budgets of the port's CUDA kernels, measured side by side on
one CUDA card.

    python3 kernel_budget.py [--kernels STEM,...] [--reference DIR]...
                             [--budget NAME=A,B,C,D]... [--fmad]

Builds the kernels of ``kid_tpu_torch/micro/csrc`` named by ``--kernels``
(default all seven: ``fused_step``, ``fused_kid_step``, ``fused_rates``,
``fused_post``, ``table_stage``, ``advect``, ``lookup_stage``) as
shipped, and once more per
``--budget``: each kernel's register-budget macros of
``csrc/thompson.cuh`` (blocks of 128 threads that must fit on an SM) for
float32 mixed, float32 warm, float64 mixed and float64 warm, set to A,
B, C and D (``BUDGET_MACROS``).  Each
``--reference`` builds the same files from another source directory (for
instance the ``csrc`` of an earlier commit), first, in the order given.
``--fmad`` adds a build of the shipped budget with ``-fmad=true``.  All
builds run in parallel.  Then, on the card:

  * each build's registers, spill bytes, static shared bytes and active
    blocks per SM for every instantiation at nz 120 and 256;
  * each build's instruction counts per instantiation from its SASS
    (``cuobjdump -sass``): all, ``MUFU`` (the special-function unit),
    double-precision arithmetic (``DADD``/``DMUL``/``DFMA``) and
    conversions to or from double (``F2F`` with ``F64``);
  * every build's outputs against the first build's, bit for bit, on
    seeded batches (1000 columns; nz 33, 120 and 256; float32 and
    float64; mixed and warm; rate profiles on and off; for
    ``fused_rates`` and ``fused_post`` aerosol-aware, plus the cold batch
    of ``chip_smoke.py`` phase 2b, with ``fused_post`` fed the plain
    path's p8 and lookups, and ``lookup_stage`` on the same batches'
    state, seeded w and p8 without rate profiles; for ``table_stage``
    non-aerosol and
    aerosol-aware, where the instantiation's third template flag, which
    the SASS labels print as ``rates``, is the aerosol one; for
    ``advect`` the cells of ``chip_smoke.py`` phase 2f in float32 and
    float64, its resources labelled warm for 5 tracers, mixed for 9 and
    ``2d`` for its 2-D flag); each
    differing output is printed (``DIFFERS``) and makes the script exit
    1 once the timings are printed; the
    ``-fmad=true`` build rounds otherwise, so its differing outputs are
    counted, not gated;
  * ms/launch of each build, in turns (first to last, then last to
    first), on the main paths' own inputs at (8192, 120) float32 after a
    150-step spin-up (``table_stage`` and ``fused_step`` from mixed1's
    default step, ``fused_kid_step`` from its fused driver,
    ``table_stage``, ``fused_rates``, ``lookup_stage`` and ``fused_post``
    from aerosol1d's step (``lookup_stage`` with a seeded w); the table
    stage's input is the first 13 rows of the next
    kernel's), and on seeded warm and float64 batches at (8192, 120);
    ``advect`` on phase 2f's mixed1 and cumulus2d cells in float32.

Imports the port (``kid_tpu_torch``) and ``chip_smoke`` only; builds into
``build/kid_tpu_torch/budget/`` at the repository root.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as C
from kid_tpu_torch.micro import cuda_build

STEMS = ("fused_step", "fused_kid_step", "fused_rates", "fused_post",
         "table_stage", "advect", "lookup_stage")
_ROWS = ("F32_MIXED", "F32_WARM", "F64_MIXED", "F64_WARM")
# each kernel's budget macros in csrc/thompson.cuh, in _ROWS order
BUDGET_MACROS = {
    stem: tuple(f"{prefix}MIN_BLOCKS_{r}" for r in _ROWS)
    for stem, prefix in (("fused_step", ""), ("fused_kid_step", ""),
                         ("fused_rates", "RATES_"), ("fused_post", "POST_"),
                         ("table_stage", "TABLE_"), ("advect", "ADVECT_"),
                         ("lookup_stage", "LOOKUP_"))}
# advect's instantiations by (warm, rates) of the others' labels: its
# tracers (5 warm, 9 mixed) and its 2-D flag
ADVECT_FLAGS = {True: 5, False: 9}
OUT = Path(__file__).resolve().parent / "build" / "kid_tpu_torch" / "budget"
F32, F64 = torch.float32, torch.float64


def build_all(builds, stems):
    """Compile ``stems`` of every (name, source dir, budget, flags) build
    in parallel; returns {name: {stem: CDLL}}.  ``budget`` is None or the
    four values of each kernel's BUDGET_MACROS."""
    header = cuda_build.constants_header()
    procs = []
    for name, src, budget, flags in builds:
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "kid_constants.h").write_text(header)
        for stem in stems:
            macros = dict(zip(BUDGET_MACROS[stem], budget or ()))
            cmd = [cuda_build._nvcc(), *flags,
                   *[f"-D{k}={v}" for k, v in macros.items()],
                   "-I", str(out), "-I", str(src),
                   "-o", str(out / f"lib{stem}.so"), str(src / f"{stem}.cu")]
            procs.append((name, stem, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    errors = []
    for name, stem, proc in procs:       # every nvcc ends before a raise
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name} {stem}.cu:\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: {stem: ctypes.CDLL(str(OUT / name / f"lib{stem}.so"))
                   for stem in stems} for name, *_ in builds}


SHIPPED = cuda_build.kernel_function


def using(libs):
    """Route the wrappers' launches of ``libs``' kernels to them, and the
    other kernels' to the shipped build: a timed input's path launches
    kernels that ``--kernels`` may not name."""
    def kernel_function(stem, dtype, argtypes):
        if stem not in libs:
            return SHIPPED(stem, dtype, argtypes)
        suffix = "f32" if dtype == F32 else "f64"
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
    flag = ADVECT_FLAGS[warm] if stem == "advect" else int(warm)
    err = fn(nz, int(dtype == F64), flag, int(want_rates),
             ctypes.addressof(row))
    if err != 0:
        raise RuntimeError(f"{stem} resources: cudaError {err}")
    return tuple(row)


def cuobjdump() -> str:
    """The toolkit's cuobjdump, else the one Triton's package carries."""
    cand = Path(cuda_build._nvcc()).parent / "cuobjdump"
    if cand.exists():
        return str(cand)
    try:
        import triton
        cand = (Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
                / "cuobjdump")
        if cand.exists():
            return str(cand)
    except ImportError:
        pass
    found = shutil.which("cuobjdump")
    if found:
        return found
    raise RuntimeError("cuobjdump not found")


_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)")
# <stem>_kernel<T, WARM, RATES[, BLOCK]> in the mangled name
_TEMPLATE = re.compile(r"(\w+?)_kernelI([fd])Lb([01])ELb([01])E(?:Li(\d+)E)?E")


def sass_counts(so: Path) -> dict:
    """{instantiation label: (instructions, MUFU, DADD/DMUL/DFMA, F2F with
    F64)} of one library's SASS."""
    text = subprocess.run([cuobjdump(), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    counts, key = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            t = _TEMPLATE.search(m.group(1))
            key = (f"{'f32' if t.group(2) == 'f' else 'f64'} "
                   f"{'warm ' if t.group(3) == '1' else 'mixed'} "
                   f"rates={t.group(4)} block={t.group(5) or 'any'}"
                   if t else m.group(1))
            counts[key] = [0, 0, 0, 0]
            continue
        m = _INSTR.match(line)
        if key is None or not m or m.group(1).startswith("NOP"):
            continue
        op = m.group(1)
        row = counts[key]
        row[0] += 1
        row[1] += op.startswith("MUFU")
        row[2] += op.split(".")[0] in ("DADD", "DMUL", "DFMA")
        row[3] += op.startswith("F2F") and ".F64" in op
    return {k: tuple(v) for k, v in sorted(counts.items())}


def _label(nz, dtype, warm, rates=None):
    s = f"nz={nz} {str(dtype)[6:]} {'warm ' if warm else 'mixed'}"
    return s if rates is None else f"{s} rates={int(rates)}"


def kid_launch(x, prof, m: float, case, rates: bool):
    """A launch of ``fused_kid_step`` on packed inputs ``x`` and ``prof``
    at m(t) ``m``, which the kernel reads from the card: a one-element
    tensor of the inputs' dtype (``m`` rounded to it) on their device."""
    import kid_tpu_torch.micro.fused_kid_step as FK
    mmod = torch.tensor(m, dtype=x.dtype, device=x.device)
    return lambda: FK.launch_kid_packed(x, prof, mmod, case.micro, case.dt,
                                        rates)


def table_launch(chans, tables, cfg, dt):
    """A launch of ``table_stage`` on its 13 input channels ``chans``
    (ColumnState's, then pres), returning its output."""
    import kid_tpu_torch.micro.table_stage as TS
    from kid_tpu_torch.micro import solver as S

    def launch():
        x = chans[0]
        out = torch.empty((len(S.tv_keys(cfg)), *x.shape), dtype=x.dtype,
                          device=x.device)
        TS.launch(chans, tables, out, cfg, dt)
        return (out,)
    return launch


def advect_launch(cell, dtype, dev):
    """A launch of ``advect`` on ``chip_smoke.advect_inputs(cell, ...)``,
    returning its head rows and its provisional theta."""
    import kid_tpu_torch.driver.advection as ADV
    st, m, tr, n_adv = C.advect_inputs(cell, dtype, dev)

    def launch():
        out = torch.empty((14, *st.qv.shape), dtype=dtype, device=dev)
        theta = torch.empty(st.qv.shape, dtype=dtype, device=dev)
        ADV.launch(st, m, tr, n_adv, out, theta)
        return out, theta
    return launch


def advect_batches(dev, stems, cells, dtypes):
    """[(label, "advect", launch)] on chip_smoke's ``ADVECT_CELLS``
    ``cells`` in ``dtypes``, if ``stems`` names it."""
    if "advect" not in stems:
        return []
    return [(f"{cell} {str(dtype)[6:]}", "advect",
             advect_launch(cell, dtype, dev))
            for cell in cells for dtype in dtypes]


def step_batches(dev, stems):
    """Seeded inputs of ``fused_step``, ``fused_kid_step`` and
    ``table_stage``: [(label, stem, launch)] where ``launch()`` runs the
    routed kernel and returns its outputs."""
    import kid_tpu_torch.micro.fused_kid_step as FK
    import kid_tpu_torch.micro.fused_step as F
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.driver.cases import MIXED1, WARM1_RECON
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.tables.cache import get_tables
    out = []
    if not {"fused_step", "fused_kid_step", "table_stage"} & stems:
        return out
    for nz in (33, 120, 256):
        for dtype in (F32, F64):
            for warm in (False, True):
                cfg = MicroConfig(iiwarm=warm)
                tables = S.device_tables(get_tables(iiwarm=warm), dtype, dev)
                st, pres, dzq = C.make_batch(C.BATCH_NCOL, nz, 0, dtype, dev)
                pro, idx = S._prologue(st, pres, cfg)
                tv = S._table_stage(pro, idx, tables, cfg, 10.0)
                x = F.pack_inputs(st, pres, dzq, tv, cfg)
                case = dataclasses.replace(WARM1_RECON if warm else MIXED1,
                                           nx=C.BATCH_NCOL, nz=nz)
                if "fused_kid_step" in stems:
                    kst, m, ktv, rows = C.kid_step_inputs(case, dtype, dev)
                    kx, prof = FK.pack_kid_inputs(kst, ktv, *rows,
                                                  case.micro)
                for rates in (False, True):
                    label = _label(nz, dtype, warm, rates)
                    out.append((label, "fused_step",
                                lambda x=x, cfg=cfg, r=rates:
                                F.launch_packed(x, cfg, 10.0, r)))
                    if "fused_kid_step" in stems:
                        out.append((label, "fused_kid_step",
                                    kid_launch(kx, prof, m, case, rates)))
                if "table_stage" in stems:
                    for aero in (False, True):
                        acfg = MicroConfig(iiwarm=warm, is_aerosol_aware=aero)
                        out.append((f"{_label(nz, dtype, warm)} aero="
                                    f"{int(aero)}", "table_stage",
                                    table_launch([*st, pres], tables, acfg,
                                                 10.0)))
    return [o for o in out if o[1] in stems]


def split_inputs(ncol, nz, dtype, warm, dev, cold=False):
    """Packed seeded inputs of ``fused_rates`` and ``fused_post`` (the
    latter from the plain path's p8 and lookups, so each kernel is held
    alone), their config and the lookup stage's (w, tables)."""
    import kid_tpu_torch.micro.split_step as A
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.tables.cache import get_tables
    cfg = MicroConfig(iiwarm=warm, is_aerosol_aware=True)
    seed = 1 if cold else 0
    tables = S.device_tables(get_tables(iiwarm=warm), dtype, dev)
    st, pres, dzq = C.make_batch(ncol, nz, seed, dtype, dev, cold=cold)
    w = C.seeded_w(ncol, nz, seed, dtype, dev)
    pro, idx = S._prologue(st, pres, cfg)
    tv = S._table_stage(pro, idx, tables, cfg, 10.0)
    p8 = A.fused_rates_ref(st, pres, tv, cfg, 10.0, True)
    aux = S.aerosol_lookup_stage(st, pres, w, p8, tables, cfg, 10.0)
    return (A.pack_rates_inputs(st, pres, tv, cfg),
            A.pack_post_inputs(st, pres, dzq, p8, aux), cfg, (w, tables))


def lookup_launch(xa, xb, w, tables, cfg, dt):
    """A launch of ``lookup_stage`` on the state rows and pres of
    ``fused_rates``' packed input ``xa``, ``w`` and the tendency rows of
    ``fused_post``'s ``xb``, returning its output."""
    import kid_tpu_torch.micro.split_step as A
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.micro.state import ColumnState
    p8 = dict(zip(S.P8_OUT, xb[14:]))
    chans = ([xa[ColumnState._fields.index(k)] for k in A.LOOKUP_STATE]
             + [xa[12], w] + [p8[k] for k in A.LOOKUP_P8])

    def launch():
        out = torch.empty((len(A.AUX_KEYS), *w.shape), dtype=w.dtype,
                          device=w.device)
        A.launch_lookup(chans, tables, out, cfg, dt)
        return (out,)
    return launch


def split_launches(label, xa, xb, cfg, dt, rates, stems, look):
    """[(label, stem, launch)] of the aerosol kernels in ``stems``;
    ``look`` is the lookup stage's (w, tables), which it takes without
    rate profiles only."""
    import kid_tpu_torch.micro.split_step as A
    out = [(label, "fused_rates",
            lambda: (A.launch_rates_packed(xa, cfg, dt, rates),))]
    if not rates:
        out.append((label, "lookup_stage",
                    lookup_launch(xa, xb, *look, cfg, dt)))
    out.append((label, "fused_post",
                lambda: A.launch_post_packed(xb, cfg, dt, rates)))
    return [o for o in out if o[1] in stems]


def split_batches(dev, stems):
    """Seeded aerosol-aware inputs of ``fused_rates`` and ``fused_post``,
    as ``step_batches``, and the cold batch of chip_smoke's phase 2b."""
    out = []
    if not {"fused_rates", "fused_post", "lookup_stage"} & stems:
        return out
    specs = [(nz, dtype, warm, False) for nz in (33, 120, 256)
             for dtype in (F32, F64) for warm in (False, True)]
    specs.append((120, F64, False, True))
    for nz, dtype, warm, cold in specs:
        xa, xb, cfg, look = split_inputs(C.BATCH_NCOL, nz, dtype, warm, dev,
                                         cold)
        for rates in (False, True):
            label = ("cold " if cold else "") + _label(nz, dtype, warm, rates)
            out += split_launches(label, xa, xb, cfg, 10.0, rates, stems,
                                  look)
    return out


def timed_inputs(dev, stems):
    """[(label, stem, launch)] at (8192, 120): the main paths' own inputs
    after the spin-up (float32), then seeded warm and float64 batches;
    then ``advect`` on the loops' seeded cells (float32)."""
    import kid_tpu_torch.micro.fused_kid_step as FK
    import kid_tpu_torch.micro.fused_step as F
    import kid_tpu_torch.micro.split_step as A
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.driver.cases import AEROSOL1D, MIXED1
    from kid_tpu_torch.driver.loop import FUSED_DRIVER_ENV, run_case, simulate
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.tables.cache import get_tables
    out = []
    if {"fused_step", "fused_kid_step", "table_stage"} & stems:
        case = dataclasses.replace(MIXED1, nx=C.MAIN_NX)
        st, _ = run_case(case, F32, n_steps=C.N_SPIN, device=dev)
        tables = S.device_tables(get_tables(iiwarm=False), F32, dev)
        last, restore = C.recording([(F, "pack_inputs"),
                                     (FK, "pack_kid_inputs")])
        try:
            if {"fused_step", "table_stage"} & stems:
                simulate(st, tables, case, 1, istep0=C.N_SPIN, device=dev,
                         graphs=False)
            if "fused_kid_step" in stems:
                os.environ[FUSED_DRIVER_ENV] = "1"
                try:
                    simulate(st, tables, case, 1, istep0=C.N_SPIN,
                             device=dev, graphs=False)
                finally:
                    del os.environ[FUSED_DRIVER_ENV]
        finally:
            restore()
        label = "mixed1 (8192, 120) f32"
        if "table_stage" in stems:
            out.append((label, "table_stage", table_launch(
                list(last["pack_inputs"][:13]), tables, case.micro,
                case.dt)))
        if "fused_step" in stems:
            out.append((label, "fused_step",
                        lambda x=last["pack_inputs"], cfg=case.micro,
                        dt=case.dt: F.launch_packed(x, cfg, dt, False)))
        if "fused_kid_step" in stems:
            kx, prof = last["pack_kid_inputs"]
            out.append((label, "fused_kid_step", kid_launch(
                kx, prof, case.time_modulation(C.N_SPIN, F32), case, False)))
    if {"fused_rates", "fused_post", "table_stage", "lookup_stage"} & stems:
        case = dataclasses.replace(AEROSOL1D, nx=C.MAIN_NX)
        st, _ = run_case(case, F32, n_steps=C.N_SPIN, device=dev)
        tables = S.device_tables(get_tables(iiwarm=False), F32, dev)
        last, restore = C.recording([(A, "pack_rates_inputs"),
                                     (A, "pack_post_inputs")])
        try:
            simulate(st, tables, case, 1, istep0=C.N_SPIN, device=dev,
                     graphs=False)
        finally:
            restore()
        label = "aerosol1d (8192, 120) f32"
        if "table_stage" in stems:
            out.append((label, "table_stage", table_launch(
                list(last["pack_rates_inputs"][:13]), tables, case.micro,
                case.dt)))
        w = C.seeded_w(C.MAIN_NX, case.nz, 0, F32, dev)
        out += split_launches(label, last["pack_rates_inputs"],
                              last["pack_post_inputs"], case.micro, case.dt,
                              False, stems, (w, tables))
    for dtype, warm in ((F32, True), (F64, False), (F64, True)):
        label = f"seeded (8192, 120) {str(dtype)[6:]} " \
                f"{'warm' if warm else 'mixed'}"
        if "table_stage" in stems:
            cfg = MicroConfig(iiwarm=warm)
            tabs = S.device_tables(get_tables(iiwarm=warm), dtype, dev)
            b, pres, _ = C.make_batch(C.MAIN_NX, 120, 0, dtype, dev)
            out.append((label, "table_stage",
                        table_launch([*b, pres], tabs, cfg, 10.0)))
        if "fused_step" in stems:
            cfg = MicroConfig(iiwarm=warm)
            tabs = S.device_tables(get_tables(iiwarm=warm), dtype, dev)
            b, pres, dzq = C.make_batch(C.MAIN_NX, 120, 0, dtype, dev)
            pro, idx = S._prologue(b, pres, cfg)
            tv = S._table_stage(pro, idx, tabs, cfg, 10.0)
            xb = F.pack_inputs(b, pres, dzq, tv, cfg)
            out.append((label, "fused_step",
                        lambda xb=xb, cfg=cfg: F.launch_packed(xb, cfg, 10.0,
                                                               False)))
        if {"fused_rates", "fused_post", "lookup_stage"} & stems:
            xa, xb, cfg, look = split_inputs(C.MAIN_NX, 120, dtype, warm,
                                             dev)
            out += split_launches(label, xa, xb, cfg, 10.0, False, stems,
                                  look)
    return out + advect_batches(dev, stems, C.ADVECT_TARGETS, (F32,))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default=",".join(STEMS),
                    help="comma-separated kernels (csrc/<stem>.cu) to build")
    ap.add_argument("--reference", type=Path, action="append", default=[],
                    help="another csrc directory, built first")
    ap.add_argument("--budget", action="append", default=[],
                    metavar="NAME=A,B,C,D",
                    help="blocks of 128 threads per SM for f32 mixed, f32 "
                         "warm, f64 mixed, f64 warm")
    ap.add_argument("--fmad", action="store_true",
                    help="add the shipped budget built with -fmad=true")
    args = ap.parse_args()
    stems = [s for s in STEMS if s in args.kernels.split(",")]
    if not stems or len(stems) != len(args.kernels.split(",")):
        ap.error(f"--kernels takes names from {', '.join(STEMS)}")
    if not torch.cuda.is_available():
        print("kernel_budget: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = C.card_line()
    print(f"card: {card}", flush=True)
    flags = list(cuda_build.NVCC_FLAGS)
    builds = [(d.resolve().name, d.resolve(), None, flags)
              for d in args.reference]
    builds.append(("shipped", cuda_build.SRC_DIR, None, flags))
    for spec in args.budget:
        name, values = spec.split("=")
        builds.append((name, cuda_build.SRC_DIR,
                       tuple(map(int, values.split(","))), flags))
    if args.fmad:
        builds.append(("shipped-fmad", cuda_build.SRC_DIR, None,
                       [f if f != "-fmad=false" else "-fmad=true"
                        for f in flags]))
    libs = build_all(builds, stems)
    names = [b[0] for b in builds]
    print(f"built {', '.join(names)} of {', '.join(stems)}", flush=True)

    for name in names:
        for stem in stems:
            for nz in (120, 256):
                for dtype in (F32, F64):
                    for warm in (False, True):
                        # lookup_stage has no third flag
                        for rates in ((False,) if stem == "lookup_stage"
                                      else (False, True)):
                            r = resources(libs[name][stem], stem, nz, dtype,
                                          warm, rates)
                            label = _label(nz, dtype, warm, rates)
                            if stem == "table_stage":   # its aerosol flag
                                label = label.replace("rates=", "aero=")
                            if stem == "advect":        # its 2-D flag
                                label = label.replace("rates=", "2d=")
                            print(f"resources {name} {stem} {label}: "
                                  f"{r[0]} regs, {r[1]} spill bytes, "
                                  f"{r[2]} static shared bytes, {r[3]} "
                                  f"blocks/SM", flush=True)
    for name in names:
        for stem in stems:
            for key, (n, mufu, darith, f2f) in sass_counts(
                    OUT / name / f"lib{stem}.so").items():
                print(f"sass {name} {stem} {key}: {n} instructions, {mufu} "
                      f"MUFU, {darith} DADD/DMUL/DFMA, {f2f} F2F with F64",
                      flush=True)

    # bit for bit against the first build
    n_same, fmad_differ, n_batches, differ = 0, 0, 0, []
    for label, stem, launch in (advect_batches(dev, set(stems),
                                               C.ADVECT_CELLS, (F32, F64))
                                + step_batches(dev, set(stems))
                                + split_batches(dev, set(stems))):
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
                differ.append(f"{name} {stem} {label}")
                print(f"DIFFERS: {name} {stem} {label}: outputs differ from "
                      f"{names[0]}'s", flush=True)
            else:
                n_same += 1
    print(f"bit for bit: {n_same} (build, kernel, batch) outputs equal to "
          f"{names[0]}'s, {len(differ)} differ, {n_batches} (kernel, batch) "
          f"pairs", flush=True)
    if args.fmad:
        print(f"-fmad=true: {fmad_differ} of {n_batches} (kernel, batch) "
              f"outputs differ from {names[0]}'s", flush=True)

    using(libs[names[0]])
    inputs = timed_inputs(dev, set(stems))
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
    if differ:      # timed all the same, but the gate fails
        print(f"kernel_budget: {len(differ)} outputs differ from "
              f"{names[0]}'s", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
