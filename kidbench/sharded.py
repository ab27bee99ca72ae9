"""The case loop over ranks: ``kid_tpu_torch.dist.mesh.simulate_sharded``
on one process per card (NCCL; gloo ranks on the CPU in the tests), each
rank holding its block of the configuration's columns (``ranks`` blocks of
``nx / ranks``), its step graphed with the halo exchange inside.

Every rank drives the traffic file's schedule in lockstep, as the
one-chip ``case_loop`` does; rank 0's clock decides, after each chunk,
whether the window has closed, and tells the others over a gloo group.
Each rank keeps its check segments and writes the columns it owns of
every answer, its numbers, its trace and the forbidden modules it
holds into the run's directory; the parent merges them, runs the
reference and prints the line, or none where a rank held JAX or the JAX
package (``Outcome.loaded_elsewhere``).  The sample
holds, besides the blocks drawn from the seed, one block across each
boundary between two ranks' blocks, so that an exchange left out shows.
"""
from __future__ import annotations

import gc
import json
import os
import socket
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import compare
from .classes import CLASSES
from .drive import (CasePass, Outcome, check_loop, inner, nonfinite,
                    program_case, program_tables, sample_blocks, schedule,
                    sync)
from .inputs import initial_state
from .reference.kid import FIELDS, PPT, KidCase
from .trace import TraceSummary, traced


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# columns of the block across each boundary between two ranks: the two
# a side whose stencils reach into the neighbour's block
BOUNDARY_COLUMNS = 4


def boundary_blocks(nx: int, ranks: int) -> list:
    """(start, width) of a block across each boundary between two ranks'
    blocks (the periodic seam among them)."""
    w = BOUNDARY_COLUMNS
    return [(r * (nx // ranks) - w // 2, w) for r in range(ranks)]


def _rank_main(rank, run_dir, cfg, tr, seed, seconds, trace, devices,
               backend, init_method):
    """One rank: set-up, the window, the checks kept, its trace; writes
    ``rank<r>.json`` (with the forbidden modules this process holds once
    the window and the trace are over) and ``rank<r>.npz`` into
    ``run_dir``."""
    import torch.distributed as dist
    from torch.profiler import record_function

    from kid_tpu_torch.dist import mesh
    from kid_tpu_torch.driver.loop import BLOCKS, KidState

    from .run import loaded_forbidden

    n = len(devices)
    torch.set_num_threads(max(1, (os.cpu_count() or n) // (2 * n)))
    dev = torch.device(devices[rank])
    group = mesh.make_group(dev, backend, init_method, rank, n)
    ctl = dist.new_group(backend="gloo")
    try:
        ref = KidCase(cfg)
        case = program_case(cfg)
        lo, hi = mesh.column_block(ref.nx, rank, n)
        tables = program_tables(cfg, dev)
        dtype = getattr(torch, cfg["dtype"])
        state0 = KidState(*initial_state(ref, cfg, seed, dtype, dev,
                                         ncol=hi - lo, salt=rank + 1))
        plan = schedule(ref.n_steps, tr["chunk_steps"],
                        tr["checks_at_share"], tr["check_steps"])

        def call(st, i0, k):
            return mesh.simulate_sharded(st, tables, case, k, group,
                                         istep0=i0, device=dev)

        for k in sorted({k for _, k, _ in plan}):
            call(state0, 0, k)
        sync(dev)
        dist.barrier(ctl)
        loop = CasePass(call, state0, plan, lambda: sync(dev))
        flag = torch.zeros(1, dtype=torch.int32)
        steps, window_start = 0, time.perf_counter()
        while True:
            steps += loop.take()
            if rank == 0:
                flag[0] = int(time.perf_counter() - window_start >= seconds)
            dist.broadcast(flag, 0, group=ctl)
            if flag[0]:
                break
        window_s = time.perf_counter() - window_start
        attempted = loop.pos
        loop.finish_checks()
        kept, st = loop.kept, loop.state
        peak = (int(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else None)
        bad = nonfinite([t for _, a, b, _ in kept.values()
                         for t in (*a, *b)] + list(st))
        summary = None
        if trace:
            def cycle():
                s = state0
                for i0, k, _ in plan:
                    with record_function("kidbench.simulate"):
                        s, _ = call(s, i0, k)
                    with record_function("kidbench.synchronize"):
                        sync(dev)

            dist.barrier(ctl)
            summary = traced(cycle, ref.n_steps, dev)._asdict()
        arrays = {}
        for i0, (k, before, out, streams) in sorted(kept.items()):
            blocks = sample_blocks(ref, tr["sample"], seed, i0, k,
                                   boundary_blocks(ref.nx, n))
            ppt = (streams.ppt_rain, streams.ppt_snow, streams.ppt_graupel,
                   streams.ppt_ice)
            for b, cols in enumerate(blocks):
                for part, where, src in (("before", cols, before),
                                         ("prog", inner(ref, cols, k), out)):
                    glob = where % ref.nx
                    mine = np.nonzero((glob >= lo) & (glob < hi))[0]
                    idx = torch.as_tensor(glob[mine] - lo, device=dev)
                    arrays[f"{i0}/{b}/{part}/pos"] = mine
                    for f, t in zip(FIELDS, src):
                        arrays[f"{i0}/{b}/{part}/{f}"] = (
                            t[idx].to("cpu", torch.float64).numpy())
                    if part == "prog":
                        for name, p in zip(PPT, ppt):
                            arrays[f"{i0}/{b}/ppt/{name}"] = (
                                p[:, idx].sum(0).to("cpu", torch.float64)
                                .numpy())
        np.savez(Path(run_dir) / f"rank{rank}.npz", **arrays)
        Path(run_dir, f"rank{rank}.json").write_text(json.dumps(dict(
            steps=steps, window_s=window_s, attempted=attempted,
            window_start=window_start, peak=peak, nonfinite=bad,
            checks=sorted((i0, k) for i0, (k, *_) in kept.items()),
            trace=summary, forbidden=loaded_forbidden())))
    finally:
        loop = kept = st = state0 = None
        BLOCKS.clear()
        gc.collect()
        sync(dev)
        dist.destroy_process_group()


def merge_traces(parts: list) -> TraceSummary:
    """The ranks' traces as one: device seconds by class and the busy
    time averaged over the ranks, the window the longest, the per-rank
    classes kept (``per_rank``) for the collective's share."""
    n = len(parts)
    by_class = {c: sum(p.by_class[c] for p in parts) / n for c in CLASSES}
    ops = {}
    for p in parts:
        for name, sec in p.device_ops:
            ops[name] = ops.get(name, 0.0) + sec / n
    gaps = sorted((g for p in parts for g in p.idle_gaps),
                  key=lambda g: -g[1])
    return TraceSummary(
        units=parts[0].units, window_s=max(p.window_s for p in parts),
        busy_s=sum(p.busy_s for p in parts) / n, by_class=by_class,
        device_ops=[list(kv) for kv in sorted(ops.items(),
                                              key=lambda kv: -kv[1])[:10]],
        idle_gaps=gaps[:10],
        per_rank=[p.by_class for p in parts])


def sharded_case_loop(run, rank_main=_rank_main) -> Outcome:
    """``case_loop`` over ``cfg["ranks"]`` ranks (see the module)."""
    cfg, tr, dev = run.cfg, run.tr, run.dev
    n = int(cfg["ranks"])
    if dev.type == "cuda":
        from kid_tpu_torch.micro import cuda_build
        cuda_build.build()             # once here, not in every rank
        devices, backend = [f"cuda:{r}" for r in range(n)], "nccl"
    else:
        devices, backend = ["cpu"] * n, "gloo"
    ref = KidCase(cfg)
    program_case(cfg)
    with tempfile.TemporaryDirectory(prefix="kidbench_ranks_") as d:
        torch.multiprocessing.spawn(
            rank_main, nprocs=n, join=True,
            args=(d, cfg, tr, run.seed, run.seconds, run.trace, devices,
                  backend, f"tcp://127.0.0.1:{_free_port()}"))
        ranks = [json.loads(Path(d, f"rank{r}.json").read_text())
                 for r in range(n)]
        files = [np.load(Path(d, f"rank{r}.npz")) for r in range(n)]
        arrays = [{k: z[k] for k in z.files} for z in files]
        for z in files:
            z.close()
    r0 = ranks[0]
    setup_s = r0["window_start"] - run.t_start
    answers = []
    for i0, k in r0["checks"]:
        blocks = sample_blocks(ref, tr["sample"], run.seed, i0, k,
                               boundary_blocks(ref.nx, n))
        for b, cols in enumerate(blocks):
            a = dict(i0=i0, n=k, cols=cols, ppt={})
            for part, m in (("before", len(cols)),
                            ("prog", len(inner(ref, cols, k)))):
                got = {f: np.full((m, ref.nz), np.nan) for f in FIELDS}
                for arr in arrays:
                    pos = arr[f"{i0}/{b}/{part}/pos"]
                    for f in FIELDS:
                        got[f][pos] = arr[f"{i0}/{b}/{part}/{f}"]
                a[part] = got
            a["ppt"] = {p: np.full(len(inner(ref, cols, k)), np.nan)
                        for p in PPT}
            for arr in arrays:
                pos = arr[f"{i0}/{b}/prog/pos"]
                for p in PPT:
                    a["ppt"][p][pos] = arr[f"{i0}/{b}/ppt/{p}"]
            answers.append(a)
    gaps, control = check_loop(run, ref, answers)
    checks, where = run.checks(gaps, sum(r["nonfinite"] for r in ranks))
    summary = None
    if run.trace:
        summary = merge_traces([TraceSummary(**r["trace"]) for r in ranks])
    peaks = [r["peak"] for r in ranks if r["peak"] is not None]
    rate = r0["steps"] * ref.nx / r0["window_s"]
    return Outcome({"column_steps_per_s": rate, "setup_s": setup_s},
                   r0["attempted"], 0, max(peaks) if peaks else None,
                   checks, where, summary,
                   {"worst_gap": compare.worst(control)[0]}
                   if run.control else None,
                   tuple(sorted({m for r in ranks for m in r["forbidden"]})))
