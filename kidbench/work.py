"""The work of one microphysics step of a configuration, frozen into its
file as ``work`` so that a kernel's roofline share reads the same work
whatever implements it.

    python -m kidbench.work kidbench/configs/<name>.json

prints the block.  Bytes: the prognostic channels the scheme reads once
and writes once, and the surface precip, at the configuration's shape
and dtype; not the channels one kernel hands the next, nor the tables.
Operations: the elementwise arithmetic, comparisons, selections and
transcendentals (output elements) of the program's plain version of the
step (the table stage and phases 2-20) on the CPU, on the case's own
state after ``STATE_STEPS`` steps, counted at ``COUNT_COLUMNS`` and at
half as many columns and carried to the configuration's column count on
the line through the two (every counted op but a few hundred on (nz,)
profiles is elementwise over the columns)."""
from __future__ import annotations

import argparse
import dataclasses
import json

COUNT_COLUMNS = 256
STATE_STEPS = 150
# aten ops counted, as chip_smoke.py's OpCounter counts them
OP_NAMES = {"add", "sub", "rsub", "mul", "div", "neg", "exp", "log",
            "log10", "sqrt", "rsqrt", "pow", "maximum", "minimum", "clamp",
            "clamp_min", "clamp_max", "where", "gt", "lt", "ge", "le", "eq",
            "ne", "abs", "sign", "floor", "reciprocal", "logical_and",
            "logical_or", "logical_not", "bitwise_and", "bitwise_or",
            "bitwise_not", "sin"}


def prognostic_channels(cfg: dict) -> int:
    """The fields the scheme reads and writes: T, qv, qc, qr, nr, and in
    the mixed-phase scheme qi, ni, qs, qg (nc, nwfa, nifa too where it is
    aerosol-aware)."""
    s = cfg["scheme"]
    n = 5 if s["iiwarm"] else 9
    return n + (3 if s["is_aerosol_aware"] else 0)


def io_bytes(cfg: dict) -> int:
    """Bytes one step reads and writes once: the prognostic channels in
    and out, the (nz,) pressure and layer profiles in, 4 precip values
    a column out."""
    item = 4 if cfg["dtype"] == "float32" else 8
    ncol, nz = cfg["nx"], cfg["nz"]
    return item * (2 * prognostic_channels(cfg) * ncol * nz + 2 * nz
                   + 4 * ncol)


def count_ops(cfg: dict, ncol: int) -> int:
    """Elementwise ops of the plain version of one step at ``ncol``
    columns of the case's state after ``STATE_STEPS`` steps, on the CPU."""
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from kid_tpu_torch.driver.cases import CASES
    from kid_tpu_torch.driver.loop import initial_state, simulate
    from kid_tpu_torch.micro import ColumnState
    from kid_tpu_torch.micro.solver import column_microphysics, device_tables
    from kid_tpu_torch.tables.cache import get_tables

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ in OP_NAMES:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor):
                        self.ops += t.numel()
            return out

    dtype = getattr(torch, cfg["dtype"])
    base = CASES[cfg["program_case"]]
    case = dataclasses.replace(base, nx=base.nx if cfg["dx"] else ncol)
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype,
                           "cpu")
    st, _ = simulate(initial_state(case, dtype, "cpu"), tables, case,
                     STATE_STEPS, device="cpu")
    grid = case.grid()
    reps = -(-ncol // st.qv.shape[0])

    def wide(t):
        return t.repeat(reps, 1)[:ncol]

    exner = torch.as_tensor(grid.exner, dtype=dtype)
    state = ColumnState(
        t=wide(st.theta * exner), qv=wide(st.qv), qc=wide(st.qc),
        qi=wide(st.qi), qr=wide(st.qr), qs=wide(st.qs), qg=wide(st.qg),
        ni=wide(st.ni), nr=wide(st.nr), nc=wide(st.nc), nwfa=wide(st.nwfa),
        nifa=wide(st.nifa))
    shape = state.qv.shape
    pres = torch.as_tensor(grid.pres, dtype=dtype).expand(shape)
    dzq = torch.as_tensor(grid.dz, dtype=dtype).expand(shape)
    w_cent = None
    if case.micro.is_aerosol_aware:
        # the cell-centred w of the step after STATE_STEPS, as the
        # program's step gives it to the aerosol-aware scheme
        rho_face = np.concatenate([grid.rho0[:1],
                                   0.5 * (grid.rho0[1:] + grid.rho0[:-1]),
                                   grid.rho0[-1:]])
        w = (case.time_modulation(STATE_STEPS, dtype)
             * case.rhow_pattern(grid) / rho_face)
        w_cent = wide(torch.as_tensor(0.5 * (w[:, 1:] + w[:, :-1]),
                                      dtype=dtype))
    counter = Counter()
    with counter:
        column_microphysics(state, pres, w_cent, dzq, case.dt, tables,
                            case.micro, want_rates=False)
    return counter.ops


def work_block(cfg: dict) -> dict:
    half, full = COUNT_COLUMNS // 2, COUNT_COLUMNS
    at_half, at_full = count_ops(cfg, half), count_ops(cfg, full)
    per_col = (at_full - at_half) // (full - half)
    return {"bytes": io_bytes(cfg),
            "ops": at_full + per_col * (cfg["nx"] - full),
            "how": (f"bytes: kidbench/work.py io_bytes; ops: elementwise "
                    f"ops of the program's plain step on the CPU on the "
                    f"case's state after {STATE_STEPS} steps, "
                    f"{at_half} at {half} columns and {at_full} at "
                    f"{full}, carried to {cfg['nx']} on that line "
                    f"(kidbench/work.py count_ops)")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kidbench.work",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    print(json.dumps(work_block(cfg)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
