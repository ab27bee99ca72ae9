"""``simulate_sharded`` on spawned ranks (twin of ``run_multiproc.py`` and
``multiproc_worker.py``).

    python -m kid_tpu_torch.dist.launch --ranks 4 --device cpu
    python -m kid_tpu_torch.dist.launch --ranks 2            # on the card

runs a case (default cumulus2d, whole length, float64) once on one rank
and once on ``--ranks`` ranks, and prints one JSON line saying whether the
final fields and the rain series are the same bits; exits 1 if they are
not, 2 if the run cannot start (e.g. no card without ``--device cpu``);
``--out PATH`` also writes that report, with the card, the layouts and
each run's ms/step, as a JSON record (``records.write``; the port's
``MULTIPROC_h100.json``, the counterpart of ``run_multiproc.py``'s).

``run_sharded`` does the work: the parent writes the tables and the
initial state into a run directory once, starts one process per rank
(``spawn``, a free local port), and each rank reads its block from there,
runs ``simulate_sharded`` and gathers the result on rank 0, which writes
it back.  The devices and the backend are chosen in the parent and passed
to every rank: with one card every rank runs on ``cuda:0`` under gloo,
its halo slabs staged through the host (the ranks' processes time-slice
the card), and exchanges between two steps; with a card per rank, NCCL,
whose exchange is the first thing of the step (``mesh.exchange_in_step``).
On a card each rank replays a CUDA graph of its step, which holds the
exchange wherever the step does (``run_sharded(..., graphs=False)``: the
eager loop).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import socket
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import records, spans
from ..device import resolve_device
from ..driver.cases import CASES
from ..driver.loop import BLOCKS, KidState, initial_state
from ..micro import cuda_build
from ..micro.solver import device_tables
from ..tables.builders import Tables
from ..tables.cache import get_tables
from .mesh import (PPT_NAMES, column_block, exchange_in_step, gather_state,
                   halo_exchange_x, make_group, shard_state,
                   simulate_sharded)


class ShardedRun(NamedTuple):
    """A sharded run gathered on rank 0, as numpy."""

    fields: dict      # KidState field -> (nx, nz)
    ppt: dict         # ppt_rain, ... -> (n_steps, nx)
    profiles: dict    # stream name -> (n_steps, nx, nz)
    ranks: list       # per rank: seconds, ms/step, the exchange's
    #                   placement, calls, seconds and share, capture ms,
    #                   kernel launches, peak device bytes (warm-up and
    #                   capture included), the profiled window's numbers


def default_layout(n_ranks: int, device="cuda") -> tuple:
    """(devices, backend) for ``n_ranks`` ranks on ``device``'s kind: the
    CPU under gloo; a card per rank under NCCL where the host has as many
    cards; else every rank on one card under gloo.  A CUDA request
    without a card raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * n_ranks, "gloo"
    if 1 < n_ranks <= torch.cuda.device_count():
        return [f"cuda:{i}" for i in range(n_ranks)], "nccl"
    return [f"cuda:{dev.index or 0}"] * n_ranks, "gloo"


def _case_spec(case) -> tuple:
    """(name, changed fields) of ``case`` against the registered case of
    its name: what a rank needs to rebuild it (cases hold lambdas, which
    do not pickle)."""
    base = CASES[case.name]
    changed = {f.name: getattr(case, f.name)
               for f in dataclasses.fields(case)
               if getattr(case, f.name) != getattr(base, f.name)}
    bad = [k for k, v in changed.items() if callable(v)]
    if bad:
        raise ValueError(f"a sharded run rebuilds the case from its name; "
                         f"{bad} differ from {case.name}'s")
    return case.name, changed


def profiled_window(run, n_steps: int, device, enter) -> dict:
    """``torch.profiler`` over ``run()``, ``n_steps`` steps: the device
    time of every kernel a step (``device_ms``), that of the NCCL kernels
    (``exchange_device_ms``) and its share of ``device_ms``, the NCCL
    kernels a step and the host calls of a halo exchange a step (its span
    ``kid.halo_exchange``, which a replay of a graph that holds the
    exchange does not enter; spans are on for the window).  The device
    time leaves out the spans' and any other user annotation, which the
    profiler also draws on the device's timeline.  ``enter()`` runs under
    the profiler just before ``run()``, after the profiler's own start-up
    (a host barrier, which launches no kernel); ``entered_s``: the wall
    clock (``time.time()``) when ``run()`` began."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    was_on = spans.ON
    spans.enable()
    try:
        with profile(activities=acts) as prof:
            enter()
            entered = time.time()
            run()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        if not was_on:
            spans.disable()
    device_us = nccl_us = nccl_kernels = host_calls = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if (getattr(e, "is_user_annotation", False)
                    or e.key.startswith(spans.PREFIX)):
                continue
            device_us += e.self_device_time_total
            if "nccl" in e.key.lower():
                nccl_us += e.self_device_time_total
                nccl_kernels += e.count
        elif e.key == "kid.halo_exchange":
            host_calls += e.count
    return dict(device_ms=device_us / 1e3 / n_steps,
                exchange_device_ms=nccl_us / 1e3 / n_steps,
                exchange_device_share=nccl_us / device_us if device_us
                else None,
                nccl_kernels=nccl_kernels / n_steps,
                host_exchange_calls=host_calls / n_steps,
                entered_s=entered)


def _rank_main(rank, run_dir, devices, backend, init_method, case_spec,
               n_steps, istep0, profile_diags, warmup_steps, graphs,
               profile_steps, threads):
    """One rank: its block of the state from ``run_dir``, optional warm-up
    steps (discarded; a graphed rank captures its step there), then the run,
    timed on the host clock with the kernels' launch counts and the exchange
    counters set to 0 just before, then ``profile_steps`` more steps from
    its end under the profiler (``profiled_window``, opened on every rank
    just after a barrier of a gloo group inside the profiler, so that a
    rank's NCCL kernels do not hold its wait for the others, and the barrier
    adds no kernel); rank 0 writes the gathered result and every rank's
    numbers into ``run_dir``. ``placement``: "step" where the step holds the
    exchange, else "split"; ``exchange_share``: the host clock of the
    exchange's host calls over the run's (0 for a graph that holds the
    exchange, whose replays make none: the profiled window's
    ``exchange_device_share`` reads that exchange); ``capture_ms``: the host
    time of the rank's capture (warm-up step and capture), None if it ran
    eagerly; ``peak_bytes``: the most device memory allocated in the warm-up
    and the run (a graph's pool is allocated at its capture; its replays
    allocate nothing). Before the group goes, the captured steps go: one
    that holds NCCL sends and receives keeps the communicator in use."""
    torch.set_num_threads(threads)
    run_dir = Path(run_dir)
    name, changed = case_spec
    case = dataclasses.replace(CASES[name], **changed)
    dev = torch.device(devices[rank])
    n = len(devices)
    group = make_group(dev, backend, init_method, rank, n)
    try:
        with np.load(run_dir / "tables.npz") as z:
            host_tables = Tables(**{k: z[k] for k in Tables._fields})
        state0 = KidState(*torch.from_numpy(np.load(run_dir / "state0.npy")))
        st = KidState(*[t.to(dev) for t in shard_state(state0, rank, n)])
        tables = device_tables(host_tables, st.qv.dtype, dev)
        if dev.type == "cuda":      # the peak holds the warm-up and capture
            torch.cuda.reset_peak_memory_stats(dev)
        if warmup_steps:
            simulate_sharded(KidState(*[t.clone() for t in st]), tables,
                             case, warmup_steps, group, profile_diags,
                             istep0, dev, graphs)
        cuda_build.reset_launch_counts()
        halo_exchange_x.calls, halo_exchange_x.seconds = 0, 0.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier(group)
        t0 = time.perf_counter()
        final, streams = simulate_sharded(st, tables, case, n_steps, group,
                                          profile_diags, istep0, dev, graphs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        block = BLOCKS.get(case, st.qv.dtype, st.qv.device,
                           *column_block(case.nx, rank, n))
        stats = dict(
            rank=rank, device=str(dev), seconds=seconds,
            ms_per_step=seconds * 1e3 / max(n_steps, 1),
            placement="step" if exchange_in_step(group, dev) else "split",
            exchange_calls=halo_exchange_x.calls,
            exchange_seconds=halo_exchange_x.seconds,
            exchange_share=halo_exchange_x.seconds / seconds,
            capture_ms=block.captured.ms if block.captured else None,
            launches=cuda_build.launch_counts(),
            peak_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None))
        if profile_steps:
            host = (group if dist.get_backend(group) == "gloo"
                    else dist.new_group(backend="gloo"))
            stats["profile"] = profiled_window(
                lambda: simulate_sharded(final, tables, case, profile_steps,
                                         group, profile_diags,
                                         istep0 + n_steps, dev, graphs),
                profile_steps, dev, enter=lambda: dist.barrier(host))
        gathered = gather_state(final, streams, group)
        every = [None] * n
        dist.all_gather_object(every, stats, group=group)
        if rank == 0:
            fields, ppt, profiles = gathered
            np.savez(run_dir / "result.npz", **fields, **ppt,
                     **{f"profile/{k}": v for k, v in profiles.items()})
            (run_dir / "ranks.json").write_text(json.dumps(every))
    finally:
        block = None            # the captured steps go before the group
        BLOCKS.clear()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def run_sharded(case, n_ranks: int, n_steps: int, dtype=torch.float64,
                devices=None, backend=None, istep0: int = 0, state0=None,
                profile_diags=False, warmup_steps: int = 0,
                graphs: bool = True, profile_steps: int = 0) -> ShardedRun:
    """``n_steps`` of ``case`` from ``state0`` (default: the initial
    sounding in ``dtype``) on ``n_ranks`` spawned ranks; returns rank 0's
    gathered ``ShardedRun``.  ``devices`` (one per rank) and ``backend``
    default to ``default_layout(n_ranks)``, which needs a card; pass
    ``devices=["cpu"] * n_ranks`` to run on the CPU.  ``warmup_steps``
    steps run first on every rank and are discarded, so that the timed
    run (``ShardedRun.ranks``) does not hold first-call costs (the
    capture among them).  ``graphs``: as ``simulate_sharded``'s, on every
    rank.  ``profile_steps`` more steps, if any, run on every rank under
    the profiler (``ShardedRun.ranks[r]["profile"]``)."""
    layout = default_layout(n_ranks) if devices is None else None
    devices = layout[0] if devices is None else list(devices)
    backend = backend or (layout[1] if layout else "gloo")
    devices = [str(resolve_device(d)) for d in devices]
    if len(devices) != n_ranks:
        raise ValueError(f"{len(devices)} devices for {n_ranks} ranks")
    column_block(case.nx, 0, n_ranks)
    spec = _case_spec(case)
    if any(d.startswith("cuda") for d in devices):
        cuda_build.build()      # once here, not in every rank
    if state0 is None:
        state0 = initial_state(case, dtype, "cpu")
    state0 = np.stack([_host(torch.as_tensor(_host(a)).to(dtype))
                       for a in state0])
    with tempfile.TemporaryDirectory(prefix="kid_ranks_") as run_dir:
        tables = get_tables(iiwarm=case.micro.iiwarm)
        np.savez(Path(run_dir) / "tables.npz", **tables._asdict())
        np.save(Path(run_dir) / "state0.npy", state0)
        torch.multiprocessing.spawn(
            _rank_main, nprocs=n_ranks, join=True, args=(
                run_dir, devices, backend,
                f"tcp://127.0.0.1:{_free_port()}", spec, n_steps, istep0,
                profile_diags, warmup_steps, graphs, profile_steps,
                max(1, torch.get_num_threads() // n_ranks)))
        with np.load(Path(run_dir) / "result.npz") as z:
            out = {k: z[k] for k in z.files}
        ranks = json.loads((Path(run_dir) / "ranks.json").read_text())
    return ShardedRun(
        fields={k: out[k] for k in KidState._fields},
        ppt={k: out[k] for k in PPT_NAMES},
        profiles={k.split("/", 1)[1]: v for k, v in out.items()
                  if k.startswith("profile/")},
        ranks=ranks)


def compare(a: ShardedRun, b: ShardedRun) -> dict:
    """Per final field and rain series: bit-equal, and the largest
    absolute difference."""
    pairs = {**{k: (a.fields[k], b.fields[k]) for k in KidState._fields},
             "ppt_rain": (a.ppt["ppt_rain"], b.ppt["ppt_rain"])}
    return {k: {"bitwise_equal": bool(np.array_equal(x, y)),
                "max_abs_diff": float(np.abs(x.astype(np.float64)
                                             - y).max())}
            for k, (x, y) in pairs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kid_tpu_torch.dist.launch",
        description="A case on 1 rank against N ranks, bit for bit.")
    ap.add_argument("--case", default="cumulus2d", choices=sorted(CASES))
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--steps", type=int, default=None,
                    help="steps (default: the case's length)")
    ap.add_argument("--dtype", default="float64",
                    choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the report, with where it ran, as a "
                         "JSON record (MULTIPROC_h100.json)")
    args = ap.parse_args(argv)
    case = CASES[args.case]
    n = case.n_steps if args.steps is None else args.steps
    dtype = getattr(torch, args.dtype)
    t0 = time.perf_counter()
    try:
        runs = [run_sharded(case, k, n, dtype,
                            *default_layout(k, args.device))
                for k in (1, args.ranks)]
    except (RuntimeError, ValueError) as e:
        print(f"launch: {e}", file=sys.stderr)
        return 2
    fields = compare(*runs)
    same = all(v["bitwise_equal"] for v in fields.values())
    report = {
        "case": case.name, "nx": case.nx, "nz": case.nz, "n_steps": n,
        "dtype": args.dtype, "ranks": [1, args.ranks],
        "layouts": [{"ranks": len(run.ranks),
                     "devices": [r["device"] for r in run.ranks],
                     "exchange": run.ranks[0]["placement"],
                     "ms_per_step": max(r["ms_per_step"] for r in run.ranks)}
                    for run in runs],
        "fields": fields, "bitwise_identical": same,
        "seconds": round(time.perf_counter() - t0, 1)}
    if args.out:
        records.write(args.out, report, resolve_device(args.device))
    print(json.dumps(report))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
