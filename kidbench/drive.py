"""The one general generator: drives the program as a traffic file says,
measures the window, keeps the answers the window produced, and holds
them against the reference.

Two drivers, named by the traffic file's ``driver``:

``case_loop``: the KiD case loop through ``kid_tpu_torch.driver.loop.
simulate``, called in chunks of ``chunk_steps`` steps with ``istep0``
advancing through the case, from the seeded initial state at t = 0, and
from it again once the case has ended.  Short segments of
``check_steps`` steps at ``checks_at_share`` of the case (each rounded
to a whole chunk) are the answers compared: the first time the window
passes each, its input and output states are kept (they are the
program's own returned tensors: no copy in the window).  A
synchronisation ends every chunk; the window ends at the one after the
chunk that crosses ``--seconds``.

``call_loop``: one caller in a closed loop calling the WRF-shaped entry
``kid_tpu_torch.driver.wrf_adapter.mp_driver_3d`` on the configuration's
(i, k, j) tile, each call on the next of ``pool`` seeded tiles made at
set-up, waiting for each call's outputs.  Each call is timed by CUDA
events from its issue to its last output; the last call's outputs of
each pool tile are the answers compared.

``env`` in a traffic file sets environment variables of the program
before anything of it runs."""
from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import compare
from .inputs import column_sample, example_tile, initial_state
from .reference import wrf
from .reference.kid import (FIELDS, PPT, SOUNDINGS, KidCase, advance,
                             to_bfloat16)
from .reference.pool import Solver
from .trace import TraceSummary, traced


class Outcome(NamedTuple):
    e2e: dict                 # end-to-end metric -> value
    attempted: int
    failed: int
    memory_peak_bytes: Optional[int]
    checks: dict              # name -> (value, limit)
    where: str                # the answer/field of the worst gap
    trace: Optional[TraceSummary]
    control: Optional[dict]   # name -> the control's reading
    # forbidden modules that another process of the run (a rank) loaded
    loaded_elsewhere: tuple = ()


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program_case(cfg: dict):
    """The program's ``Case`` for the configuration; raises where the
    program's case differs from what the file states: a scalar of the
    case, a switch of the scheme, or a sounding (``check_soundings``)."""
    from kid_tpu_torch.driver.cases import CASES
    case = dataclasses.replace(CASES[cfg["program_case"]], nx=cfg["nx"],
                               cell_nx=cfg["cell_nx"],
                               t_final=cfg["t_final"])
    for k in ("nz", "ztop", "dt", "w1", "t1", "modulation", "dx", "u0"):
        if getattr(case, k) != cfg[k]:
            raise ValueError(f"the program's {case.name} has {k} = "
                             f"{getattr(case, k)!r}, the configuration "
                             f"{cfg[k]!r}")
    micro = micro_config(cfg)
    for f in dataclasses.fields(micro):
        if f.name != "dtype" and (getattr(micro, f.name)
                                  != getattr(case.micro, f.name)):
            raise ValueError(f"the program's {case.name} has {f.name} = "
                             f"{getattr(case.micro, f.name)!r}, the "
                             f"configuration {getattr(micro, f.name)!r}")
    check_soundings(cfg, case)
    return dataclasses.replace(case, micro=micro)


SOUNDING_RTOL = 1e-12


def check_soundings(cfg: dict, case):
    """Holds the file's soundings (theta, qv, nwfa, nifa; an absent nwfa
    or nifa stands for the fills) against the program's initial state of
    ``case`` at the cell centres, in float64, to ``SOUNDING_RTOL``;
    raises naming the field and its worst level."""
    from kid_tpu_torch.driver.loop import initial_state as program_state
    ref = KidCase(cfg)
    mine = ref.initial_profiles()
    theirs = program_state(dataclasses.replace(case, nx=1, cell_nx=0),
                           torch.float64, "cpu")
    for f in SOUNDINGS:
        want = getattr(theirs, f)[0].numpy()
        gap = np.abs(mine[f] - want)
        rel = np.divide(gap, np.abs(want), where=want != 0,
                        out=np.where(gap == 0, 0.0, np.inf))
        k = int(np.argmax(rel))
        if not rel[k] <= SOUNDING_RTOL:
            raise ValueError(
                f"the program's {case.name} has {f} = {float(want[k])!r} "
                f"at level {k} ({float(ref.grid.z[k])!r} m), the "
                f"configuration {float(mine[f][k])!r}: {rel[k]:.3g} apart, "
                f"over {SOUNDING_RTOL:g}")


def micro_config(cfg: dict):
    from kid_tpu_torch.config import MicroConfig
    return MicroConfig(**cfg["scheme"], dtype=cfg["dtype"])


def program_tables(cfg: dict, dev):
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    return device_tables(get_tables(iiwarm=cfg["scheme"]["iiwarm"]),
                         getattr(torch, cfg["dtype"]), dev)


def nonfinite(tensors) -> int:
    return int(sum(int((~torch.isfinite(t)).sum()) for t in tensors))


def free_program(dev):
    """Drop the program's cached graphs, flows and memory."""
    from kid_tpu_torch.driver.loop import BLOCKS
    from kid_tpu_torch.micro.graphs import GRAPHS
    BLOCKS.clear()
    GRAPHS.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def schedule(n_steps: int, chunk: int, at_share: list, check: int) -> list:
    """One pass of the case as (istep0, steps, is a check) segments."""
    starts = sorted({min(n_steps - chunk, int(round(s * n_steps / chunk))
                         * chunk) for s in at_share})
    plan, i = [], 0
    while i < n_steps:
        if i in starts:
            plan.append((i, check, True))
            i += check
        n = min(chunk - i % chunk, n_steps - i)
        plan.append((i, n, False))
        i += n
    return plan


def timed_window(step, seconds: float, clock=time.perf_counter) -> tuple:
    """``step()`` again and again until ``seconds`` have passed since the
    first began; ``step`` returns the work it completed and ends with it
    done (synchronised).  Returns (all the work, all the time, steps)."""
    work, n, t0 = 0, 0, clock()
    while True:
        work += step()
        n += 1
        elapsed = clock() - t0
        if elapsed >= seconds:
            return work, elapsed, n


def latency_p95(ms: list) -> float:
    """The 95th percentile of ``ms`` (``statistics.quantiles``,
    exclusive method)."""
    if len(ms) < 2:
        return float(ms[0])
    return statistics.quantiles(ms, n=20)[-1]


class Run:
    """What both drivers share: the cell, its seed, its device and its
    clock."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, dev,
                 t_start: float, control: bool, workers: int):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.dev, self.t_start = trace, dev, t_start
        self.control, self.workers = control, workers
        self.cfg, self.tr = cell.cfg, cell.traffic
        self.dtype = getattr(torch, self.cfg["dtype"])
        for k, v in self.tr.get("env", {}).items():
            os.environ[k] = str(v)

    def memory_peak(self):
        if self.dev.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.dev))
        return None

    def checks(self, gaps: dict, n_nonfinite: int):
        value, where = compare.worst(gaps)
        limits = self.cell.limits
        return {"worst_gap": (value, limits["worst_gap"]),
                "nonfinite": (n_nonfinite, 0)}, where


def sample_blocks(ref: KidCase, samp: dict, seed: int, i0: int, n: int,
                  extra=()) -> list:
    """The global columns (unwrapped; index them modulo nx) of the
    answers of the check at step ``i0`` of ``n`` steps: 1-D, one sample
    of ``columns`` drawn from the seed; 2-D, ``blocks`` blocks of
    ``block_columns`` at starts drawn from the seed, and the ``extra``
    (start, width) blocks, each with the 2 * ``n`` ghost columns a side
    the reference's steps consume."""
    if ref.one_d:
        return [column_sample(seed, ref.nx, samp["columns"], i0)]
    width = samp["block_columns"]
    blocks = [(s, width) for s in column_sample(seed, ref.nx,
                                                  samp["blocks"], i0)]
    return [np.arange(s - 2 * n, s + w + 2 * n)
            for s, w in (*blocks, *extra)]


def inner(ref: KidCase, cols: np.ndarray, n: int) -> np.ndarray:
    """The columns of a block that the reference's ``n`` steps return."""
    return cols if ref.one_d else cols[2 * n:len(cols) - 2 * n]


def loop_answer(ref: KidCase, i0: int, n: int, cols, before, out, streams,
                dev) -> dict:
    """One answer on the host: the state before at ``cols``, the state
    after and the surface precip summed over the steps at the inner
    columns."""
    idx = torch.as_tensor(cols % ref.nx, device=dev)
    jdx = torch.as_tensor(inner(ref, cols, n) % ref.nx, device=dev)
    ppt = (streams.ppt_rain, streams.ppt_snow, streams.ppt_graupel,
           streams.ppt_ice)
    return dict(i0=i0, n=n, cols=cols,
                before={f: host(t[idx]) for f, t in zip(FIELDS, before)},
                prog={f: host(t[jdx]) for f, t in zip(FIELDS, out)},
                ppt={k: host(p[:, jdx].sum(0)) for k, p in zip(PPT, ppt)})


def check_loop(run, ref: KidCase, answers: list) -> tuple:
    """The reference from each answer's state before; returns the gaps
    by answer and field, and the control's where asked for."""
    gaps, control = {}, {}
    with Solver(run.cfg["scheme"]["iiwarm"], run.workers) as solve:
        for a in answers:
            name = f"step{a['i0']}+{a['n']}@{int(a['cols'][0])}"
            got, cols, ppt = advance(ref, solve, a["before"], a["cols"],
                                     a["i0"], a["n"])
            cut = (len(a["cols"]) - len(cols)) // 2
            before = {f: v[cut:len(v) - cut]
                      for f, v in a["before"].items()}
            gaps[name] = compare.gaps(before, {**a["prog"], **a["ppt"]},
                                      {**got, **ppt})
            if run.control:
                low, _, low_ppt = advance(ref, solve, a["before"], a["cols"],
                                          a["i0"], a["n"], lower="bfloat16")
                control[name] = compare.gaps(before, {**low, **low_ppt},
                                             {**got, **ppt})
    return gaps, control


class CasePass:
    """The case loop's traffic: ``take()`` runs the next segment of
    ``plan`` with ``call(state, istep0, steps)`` from the state the last
    one left (from ``state0`` where the case starts again), then
    ``done()``; it keeps (steps, state before, state after, streams) of
    the first pass through each check segment in ``kept`` and returns
    the steps it took."""

    def __init__(self, call, state0, plan: list, done):
        self.call, self.state0, self.plan, self.done = call, state0, plan, done
        self.state, self.pos, self.kept = state0, 0, {}
        self.n_checks = sum(chk for _, _, chk in plan)

    def take(self) -> int:
        i0, n, chk = self.plan[self.pos % len(self.plan)]
        if i0 == 0:
            self.state = self.state0
        out, streams = self.call(self.state, i0, n)
        if chk and i0 not in self.kept:
            self.kept[i0] = (n, self.state, out, streams)
        self.state = out
        self.pos += 1
        self.done()
        return n

    def finish_checks(self):
        """Goes on, untimed, to a check segment the window did not
        reach."""
        while len(self.kept) < self.n_checks:
            self.take()


def case_loop(run: Run) -> Outcome:
    from kid_tpu_torch.driver import loop as L
    cfg, tr, dev = run.cfg, run.tr, run.dev
    ref = KidCase(cfg)
    case = program_case(cfg)
    tables = program_tables(cfg, dev)
    state0 = L.KidState(*initial_state(ref, cfg, run.seed, run.dtype, dev))
    plan = schedule(ref.n_steps, tr["chunk_steps"], tr["checks_at_share"],
                    tr["check_steps"])

    def call(st, i0, n):
        return L.simulate(st, tables, case, n, istep0=i0, device=dev)

    for n in sorted({n for _, n, _ in plan}):
        call(state0, 0, n)
    sync(dev)
    setup_s = time.perf_counter() - run.t_start

    loop = CasePass(call, state0, plan, lambda: sync(dev))
    steps, window_s, attempted = timed_window(loop.take, run.seconds)
    loop.finish_checks()
    kept, st = loop.kept, loop.state
    peak = run.memory_peak()
    bad = nonfinite([t for _, a, b, _ in kept.values() for t in (*a, *b)]
                    + list(st))

    summary = None
    if run.trace:
        from torch.profiler import record_function

        def cycle():
            s = state0
            for i0, n, _ in plan:
                with record_function("kidbench.simulate"):
                    s, _ = call(s, i0, n)
                with record_function("kidbench.synchronize"):
                    sync(dev)

        summary = traced(cycle, ref.n_steps, dev)

    answers = []
    for i0, (n, before, out, streams) in sorted(kept.items()):
        for cols in sample_blocks(ref, tr["sample"], run.seed, i0, n):
            answers.append(loop_answer(ref, i0, n, cols, before, out,
                                       streams, dev))
    del loop, kept, st, state0, tables
    free_program(dev)
    gaps, control = check_loop(run, ref, answers)
    checks, where = run.checks(gaps, bad)
    rate = steps * ref.nx / window_s
    return Outcome({"column_steps_per_s": rate, "setup_s": setup_s},
                   attempted, 0, peak, checks, where, summary,
                   {"worst_gap": compare.worst(control)[0]}
                   if run.control else None)


def call_timer(dev):
    """``timer(fn) -> (fn(), ms)``: a call timed from its issue until its
    outputs are ready, by CUDA events on a card (the device's clock),
    else by the host's."""
    if dev.type != "cuda":
        def timer(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        return timer
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def timer(fn):
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)
    return timer


ARGS_3D = ("qv", "qc", "qr", "qi", "qs", "qg", "ni", "nr", "th", "pii", "p",
           "w", "dz")


def call_loop(run: Run) -> Outcome:
    from kid_tpu_torch.driver import wrf_adapter as W
    cfg, tr, dev = run.cfg, run.tr, run.dev
    if tr["entry"] != "mp_driver_3d":
        raise ValueError(f"unknown call entry {tr['entry']!r}")
    tables = program_tables(cfg, dev)
    mcfg = micro_config(cfg)
    tiles = [example_tile(tr["batch"], cfg, run.seed, p, run.dtype, dev)
             for p in range(tr["pool"])]

    def call(tile):
        return W.mp_driver_3d(*(tile[k] for k in ARGS_3D), cfg["dt"],
                              tile["rainnc"], tile["snownc"],
                              tile["graupelnc"], tables, mcfg,
                              want_eff_rad=False, device=dev)

    for tile in tiles[:2]:
        call(tile)
    sync(dev)
    setup_s = time.perf_counter() - run.t_start

    lat, kept = [], {}
    timer = call_timer(dev)

    def take():
        p = len(lat) % len(tiles)
        kept[p], ms = timer(lambda: call(tiles[p]))
        lat.append(ms)
        return 1

    k = timed_window(take, run.seconds)[0]
    peak = run.memory_peak()
    bad = nonfinite([t for fields, precip, _ in kept.values()
                     for t in (*fields.values(), *precip)])

    summary = None
    if run.trace:
        from torch.profiler import record_function
        n_traced = tr["trace_calls"]

        def calls():
            for i in range(n_traced):
                with record_function("kidbench.mp_driver_3d"):
                    call(tiles[i % len(tiles)])
                with record_function("kidbench.synchronize"):
                    sync(dev)

        summary = traced(calls, n_traced, dev)

    answers = []
    for p, (fields, precip, _) in sorted(kept.items()):
        tile = tiles[p]
        ni, _, nj = cfg["tile"]
        flat = column_sample(run.seed, ni * nj, tr["sample_columns"], p)
        ii = torch.as_tensor(flat // nj, device=dev)
        jj = torch.as_tensor(flat % nj, device=dev)

        def cols(t):
            return host(t[ii, :, jj] if t.dim() == 3 else t[ii, jj])

        prog = {k: cols(v) for k, v in fields.items()}
        prog.update(rainnc=cols(precip.rainnc), snownc=cols(precip.snownc),
                    graupelnc=cols(precip.graupelnc))
        answers.append((p, flat, {k: cols(v) for k, v in tile.items()},
                        prog))
    del kept, tiles, tables
    free_program(dev)

    gaps, control = {}, {}
    scheme = cfg["scheme"]
    with Solver(scheme["iiwarm"], run.workers) as solve:
        for p, flat, inp, prog in answers:
            n = len(flat)
            col = [{k: v[s] for k, v in inp.items()} for s in range(n)]
            outs = solve([wrf.column_args(c, cfg["dt"], scheme)
                          for c in col])
            ref = [wrf.call_outputs(c, o) for c, o in zip(col, outs)]
            got = {k: np.stack([r[k] for r in ref]) for k in ref[0]}
            before = {k: inp[k] for k in wrf.IN_FIELDS}
            before.update({k: inp[k] for k in wrf.ACCUMULATORS})
            gaps[f"tile{p}"] = compare.gaps(before, prog, got)
            if run.control:
                low_in = [{k: (to_bfloat16(v) if np.ndim(v) else v)
                           for k, v in c.items()} for c in col]
                low_outs = solve([wrf.column_args(c, cfg["dt"], scheme)
                                  for c in low_in])
                low = [wrf.call_outputs(c, o)
                       for c, o in zip(low_in, low_outs)]
                low = {k: to_bfloat16(np.stack([r[k] for r in low]))
                       for k in low[0]}
                control[f"tile{p}"] = compare.gaps(before, low, got)
    checks, where = run.checks(gaps, bad)
    return Outcome({"call_ms_p95": latency_p95(lat), "setup_s": setup_s},
                   k, 0, peak, checks, where, summary,
                   {"worst_gap": compare.worst(control)[0]}
                   if run.control else None)


DRIVERS = {"case_loop": case_loop, "call_loop": call_loop}
# a configuration with ``ranks`` > 1 runs ``case_loop`` over ranks
# (``sharded.sharded_case_loop``)


def run_cell(cell, seed: int, seconds: float, trace: bool, dev,
             t_start: float, control: bool = False,
             workers: int = 6) -> Outcome:
    """The cell's run: set-up, the window, the trace if asked, the
    comparison."""
    run = Run(cell, seed, seconds, trace, dev, t_start, control, workers)
    if cell.cfg.get("ranks", 1) > 1:
        from .sharded import sharded_case_loop
        return sharded_case_loop(run)
    return DRIVERS[cell.traffic["driver"]](run)
