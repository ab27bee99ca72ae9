#!/usr/bin/env python3
"""The sharded loop across cards: NCCL ranks, one card each, against one
process.

    python3 nccl_smoke.py

Needs two or more CUDA cards (the 4-rank runs need four) and imports the
port (``kid_tpu_torch``) only.  cumulus2d at its 64 x 60 (300 steps) and
the flagship, cumulus2d at 131072 x 60 (20 steps), each after 20 warm-up
steps, in float32: once on one rank (cuda:0, gloo, its wrap local) and
then on 2 and 4 NCCL ranks (``dist.launch.default_layout``), each rank
graphed (its step, the halo exchange first, replayed as one CUDA graph)
and eager.  Every sharded run must equal the single process bit for bit
(the final fields and the four precip series), with the exchange in the
step, one halo exchange and one ``advect``, ``table_stage`` and ``fused_step``
launch a step on every rank, and no host time in the exchange when
graphed (the replays hold it).  Then each case once more, graphed on the
most ranks, with ``PROFILED`` more steps under the profiler, which must
see one NCCL kernel a step and no host call of the exchange.  Prints the
cards' names and power limits, then one JSON line per run with each
rank's ms/step (host clock, its own window), the exchange's host share,
capture ms and peak device memory, and for the profiled runs the NCCL
kernels' device ms a step and their share of the rank's device ms a
step; exits 1 on a fault, 2 with fewer than two cards.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from kid_tpu_torch.dist import launch  # noqa: E402
from kid_tpu_torch.driver.cases import CUMULUS2D  # noqa: E402

FLAGSHIP = dataclasses.replace(CUMULUS2D, nx=131072, cell_nx=CUMULUS2D.nx)
# the kernels of a step, each launched once
STEP_KERNELS = ("advect", "table_stage", "fused_step")
# (case, steps timed, warm-up steps)
RUNS = ((CUMULUS2D, 300, 20), (FLAGSHIP, 20, 20))
PROFILED = 5           # steps of each rank's profiled window


def faults(one, run, n, graphs) -> list:
    """What keeps ``run`` from being the single process's bits, with the
    exchange in the step, one exchange and one launch of each of
    ``STEP_KERNELS`` a step on every rank, no host time in the exchange
    if graphed, and, in
    a profiled window, one NCCL kernel a step and no host call of the
    exchange if graphed (one a step if eager)."""
    bad = [k for k in one.fields if not np.array_equal(one.fields[k],
                                                       run.fields[k])]
    bad += [k for k in one.ppt if not np.array_equal(one.ppt[k],
                                                     run.ppt[k])]
    host_calls = 0.0 if graphs else 1.0
    for r in run.ranks:
        prof = r.get("profile")
        if (r["placement"] != "step" or r["exchange_calls"] != n
                or r["launches"] != {k: n if k in STEP_KERNELS else 0
                                     for k in r["launches"]}
                or (graphs and r["exchange_seconds"] != 0.0)
                or (prof is not None
                    and (prof["nccl_kernels"] != 1.0
                         or prof["host_exchange_calls"] != host_calls))):
            bad.append(f"rank {r['rank']}: exchange {r['placement']}, "
                       f"{r['exchange_calls']} exchanges, "
                       f"{r['exchange_seconds']} s on the host, launches "
                       f"{r['launches']}, profiled {prof}")
    return bad


def numbers(ranks) -> list:
    return [{"device": r["device"], "ms_per_step": r["ms_per_step"],
             "placement": r["placement"],
             "exchange_share": r["exchange_share"],
             **{k: r["profile"][k] for k in (
                 "device_ms", "exchange_device_ms", "exchange_device_share",
                 "nccl_kernels", "host_exchange_calls")
                if "profile" in r},
             "capture_ms": r["capture_ms"],
             "peak_gib": r["peak_bytes"] / 2**30} for r in ranks]


def main() -> int:
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"nccl_smoke: {cards} CUDA cards; NCCL ranks need two or more",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    failed = False
    for case, n, warm in RUNS:
        one = launch.run_sharded(case, 1, n, torch.float32, ["cuda:0"],
                                 "gloo", warmup_steps=warm)
        print(json.dumps({"nx": case.nx, "steps": n, "ranks": 1,
                          "backend": "gloo", "graphs": True,
                          "ranks_numbers": numbers(one.ranks)}), flush=True)
        most = max(k for k in (2, 4) if k <= cards)
        for k, graphs, profiled in ((2, True, 0), (2, False, 0),
                                    (4, True, 0), (4, False, 0),
                                    (most, True, PROFILED)):
            if k > cards:
                continue
            devices, backend = launch.default_layout(k)
            run = launch.run_sharded(case, k, n, torch.float32, devices,
                                     backend, warmup_steps=warm,
                                     graphs=graphs, profile_steps=profiled)
            bad = faults(one, run, n, graphs)
            failed |= bool(bad)
            print(json.dumps({"nx": case.nx, "steps": n, "ranks": k,
                              "backend": backend, "graphs": graphs,
                              "profiled_steps": profiled,
                              "bitwise_equal_to_one_process": not bad,
                              "faults": bad,
                              "ranks_numbers": numbers(run.ranks)}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
