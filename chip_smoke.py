#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; imports
the port (``kid_tpu_torch``) only.  Phases, each of which exits non-zero
on failure:

  1. card and build: the card's name and power limit, then the kernels
     of ``kid_tpu_torch/micro/csrc`` (``advect``, ``table_stage``,
     ``fused_step``, ``fused_rates``, ``lookup_stage``, ``fused_post``,
     ``fused_kid_step``),
     built together, and what the card gives each instantiation
     (registers, spill bytes, static shared bytes, active blocks per SM at
     nz 120 and 256; ``advect`` at nz 60, 120 and 130, 5, 9 and 12
     tracers, 1-D and 2-D, its shared bytes with its tile's slabs);
  2. ``fused_step`` against its plain PyTorch version on the card (its
     table-stage channels from the plain table stage, as in 2b-2d), on a
     seeded synthetic batch (ncol=1000, nz 120 and 130 in float64 and
     float32, and nz 33, 64, 97 and 256 in float64, which put a warp edge
     at one level, a full warp, a ragged warp and eight warps; mixed and
     warm, rate profiles on and off);
  2b. ``fused_rates`` and ``fused_post`` against their plain versions on
     the same batches with aerosol-aware configs (``fused_post`` fed the
     plain path's own p8 and lookups, so each kernel is held alone), and
     a cold, ice-supersaturated batch whose printed counts show DeMott
     nucleation and the aerosol tendencies firing;
  2c. ``fused_kid_step`` (the fused 1-D driver step) against its plain
     version on seeded driver states (ncol=1000, the nz and dtypes of
     phase 2, mixed and warm, rate profiles on and off) with the
     table-stage channels built from the driver's provisional state, at
     a step inside the updraft pulse;
  2d. ``fused_step`` against its plain version at the 2-D cases' nz 60
     (blocks of 64 threads), float64 and float32, mixed and warm, rate
     profiles on and off, on phase 2's seeded batch; its digests print
     apart from phase 2's;
  3. the main path: mixed1 widened to 8192 columns x 120 levels in
     float32 through ``simulate``, which captures its step as a CUDA
     graph in the 150 spin-up steps and replays it in 50 steps into the
     updraft pulse, timed as 5 windows of 10 steps (median and best), with
     a profile of 5 more steps, the kernels' launch counts (``advect``,
     ``table_stage`` and ``fused_step`` once a step), outputs checked
     finite and non-negative, and ``fused_step`` timed against its plain
     version on the main path's own inputs;
  3b. the aerosol main path: aerosol1d widened the same way, through
     ``table_stage`` -> ``fused_rates`` -> ``lookup_stage`` ->
     ``fused_post``
     (each launched once per step), with the same checks, profile and
     timings, and the share of cells and of warps in which each guard of
     the two split kernels runs on their last inputs;
  3c. the fused driver: mixed1 widened the same way with
     KID_TPU_TORCH_FUSED_DRIVER=1 (set by this script), through
     ``table_stage`` and ``fused_kid_step``, with the same checks, profile
     and timings, its ms/step printed beside phase 3's;
  2e. (run after 3c, on their inputs) ``table_stage`` against its plain
     version: on the last inputs of mixed1's and aerosol1d's main paths
     (phases 3 and 3b) and of warm1 widened the same way (150 steps, then
     one step recorded) at (8192, 120) f32, on a seeded (256, 120) f64
     batch (mixed, aerosol-aware, warm) and at the 2-D cases' nz 60 (f32
     and f64, mixed and warm): f64 within 1e-9 normalised outside the
     counted index flips, f32 under the knife-edge model, the number of
     cells whose channels differ by more than the noise threshold (an
     index flipped at a knife edge) printed; a digest of each batch and a
     combined one, ms/launch, the plain version's ms, the bound and the
     registers, spill and blocks per SM;
  2f. (run after 2e) ``advect``, the driver step's transport, against
     its plain version (``driver/advection.py::advect_ref``, the step's
     torch composition) bit for bit in float32 and float64, every head
     row and the provisional theta: mixed1, warm1 and aerosol1d at 8192
     columns, cumulus2d at 131072 x 60 (2048 copies of its circulation),
     orographic2d at 64 x 60, and rank 1 of 2 of that cumulus2d, its
     ghost columns from a ``Halo``; a digest a batch and a combined one,
     printed apart; at mixed1's and cumulus2d's shapes in float32 its
     ms/launch beside its byte bound and its target, and the plain
     composition's ms;
  2g. (run after 2f) ``lookup_stage``, the aerosol step's phase-14
     lookups (CCN activation and the ``tnc_wev`` gather), against its
     plain version (``solver.aerosol_lookup_stage``): on the arguments of
     aerosol1d's steps 0, 200 and 700 (float32 at 8192 columns, float64 at
     1024) and on a cold column where DeMott's and Koop's nucleation
     fire: float64 ``xnc_act`` within 1e-12 relative, ``wev`` exact and
     ``fused_post``'s outputs from the kernel's lookups within 1e-12 of
     those from the plain ones; float32 the cells whose lookup flipped at
     a knife edge counted and bounded; a digest a batch and a combined
     one; its ms/launch at 8192 and 65536 columns beside its byte bound
     and the plain version's ms;
  4. end-to-end parity on the card: mixed1, warm1_recon and aerosol1d at
     256 columns and orographic2d at its own 64 x 60, from a seeded state
     at step 150, 20 steps through the kernel path and through the plain
     path (the eager loop: a captured graph would replay the kernels), in
     float64, and orographic2d once more with
     KID_TPU_TORCH_FUSED_DRIVER=1, which a 2-D case ignores (the same
     launches, bit-identical output); mixed1 and warm1_recon through the
     fused driver the same way (the plain path swaps ``table_stage`` for
     its plain version too), and the fused driver against the default
     kernel path on the nine scheme fields and the precip (nc, nwfa and
     nifa differ by design and are printed, not gated);
  5. the 2-D path: cumulus2d (warm) and orographic2d (mixed phase) at
     their own 64 x 60 for all 900 steps in float32 through ``run_case``
     (``table_stage`` and ``fused_step`` once per step and no other
     kernel), then the same
     run through ``simulate`` in timed windows (median and best, bit for
     bit the same), a profile, scores against the float64 driver's
     finals in ``validation_finals/`` with the budgets of the reference's
     f32 validation, the worst final field (target and extra) with the
     column and level of its largest difference, and ``fused_step``
     timed on the path's last input;
  5b. ``mp_driver_3d`` on a WRF-shaped (i, k, j) = (128, 120, 64) tile of
     mixed1's sounding with phase 4's seeded layers, graphed (the
     default: a CUDA graph of the whole call) and eager, with and without
     the radii: the same bits in every field, accumulator and radius, one
     ``fused_step`` launch a call both ways, ms (events) and device ms
     (profiler) a call of each; the result equal to
     ``batched_microphysics`` on the same columns reshaped by hand, the
     accumulators and the vapor repair, ms per call and the layout moves'
     share of it, then the effective radii and ``refl_10cm`` on its
     output inside their windows; then ``batched_microphysics`` on a
     seeded (8192, 120) f32 batch, graphed and eager (mixed with rate
     profiles on and off, aerosol-aware): the same bits and launches, ms
     and device ms a call;
  6a. distribution: cumulus2d at its 64 x 60 for all 900 steps in float32
     in one process and on 2 ranks of the card (``dist.launch``, gloo,
     halo slabs staged through the host, each rank replaying a CUDA graph
     of its step with the exchange between two replays), the same bits,
     one exchange and one ``fused_step`` launch a step on each rank, the
     sharded run scored as the reference's ``cumulus2d_sharded`` row;
  6b. the flagship, cumulus2d at 131072 x 60 (2048 copies of its
     64-column circulation) in float32: 150 spin-up steps, 20 steps timed
     and profiled, ``simulate``'s set-up per call (a 0-step call, and the
     flow built as each call built it before it was kept), ``fused_step``
     on the path's last input, then the same 20 steps on 2 ranks (graphed)
     from the spun-up state, the same bits; ms/step, column-steps/s, each
     rank's ms/step, exchange share, capture ms and peak device memory;
  6c. one rank of ``simulate_sharded`` (``dist.launch``, gloo) on
     cumulus2d at its 64 x 60 for all 900 steps in float32, graphed, the
     halo exchange held in the step (its edge columns packed into the
     ghost buffers: one rank's periodic wrap), so one replay is one whole
     step: bit for bit ``simulate``'s run, one exchange and one
     ``fused_step`` counted a replay, no host call of the exchange in a
     profiled window, its ms/step beside ``simulate``'s;
  7. the five 1-D cases at full length in float32 through
     ``validation.cases``, against the oracle's float64 finals in
     ``validation_finals/`` with the reference's fixed budgets, the
     perturbed (chaos) member for mixed1, deep1 and aerosol1d;
  8. one run of ``python -m kid_tpu_torch.bench``, its JSON line printed,
     then its solver-batch rates, graphed and eager;
  9. the compiled loop against the eager one: mixed1, aerosol1d and the
     fused driver at (8192, 120), 20 steps from a seeded state at step
     150, cumulus2d and orographic2d at (64, 60) for 900 steps, and the
     flagship, 20 steps from a seeded state, each through ``simulate``
     with ``graphs=False`` and then graphed (the default), in float32:
     the same bits in the final state and every stream and the same
     launches; wall and device ms/step, busy share, kernels per step, the
     capture's ms and peak device memory of both; then cumulus2d (900
     steps, every stream) and the flagship (20 steps from a seeded state,
     two streams) on 2 ranks of the card, eager and graphed: the same bits
     in the final state and every stream, one exchange and one
     ``fused_step`` launch a step on each rank, and each rank's ms/step,
     exchange share, capture ms and peak device memory in both modes;
     aerosol1d's eager loop is profiled in two windows, the kernels a
     step of the two compared by name, and the ops two more eager calls
     dispatch must be the same;
 10. the oracle: the float64 kernel path on the card against the port's
     oracle twin (the NumPy transliteration of ``mp_thompson``) on the
     host: mixed1 and aerosol1d for 100 steps through graphed
     ``simulate`` (``fused_step``; ``fused_rates`` and ``fused_post``)
     within ``RTOL`` 1e-4 on the target fields and the cumulative rain
     and 1e-3 on nc, nwfa and nifa; cumulus2d and orographic2d at 16
     columns for 50 steps through ``validation.twod.twin_equivalence``,
     closures matched; each entry's worst field and seconds;
 11. the CLI: ``python -m kid_tpu_torch run mixed1`` for 50 steps with
     ``--out`` (NetCDF) and ``--checkpoint-dir``, then ``--resume`` to
     100: the NetCDF file byte for byte the one ``registry_from_run``
     writes from ``simulate``'s streams, the resumed state bit for bit
     ``simulate``'s over 100 steps; both runs' wall seconds;
 12. the port's measuring scripts: ``scaling``'s one-card rows
     (cumulus2d tiled to 32768 x 60, 20 timed steps in one process and on
     one rank whose graph holds its exchange, the same bits); one
     white-noise member of ``validation.chaos`` on mixed1 for 200 steps,
     its noisy step graphed and eager, the same bits, through
     ``fused_step`` and again through ``fused_kid_step`` (the fused
     switch); ``validation.cases --record`` and ``validation.chaos
     --record`` into one temporary record, its blocks checked.

Phase 9 also lists the 2-D cells' kernels by name, eager against graphed
(ROADMAP Queue 3 (c)).

Phases 3-3c, 4 (its kernel path), 5, 6, 7, 8, 10 and 11 run
``simulate``'s and ``simulate_sharded``'s default: a CUDA graph of the
step, captured once per case, column block, dtype, tables and streams and
replayed once a step (ranks sharing this card under gloo exchange their
halo on the host between two replays; one rank's graph holds its
exchange).  The
plain runs of phase 4 run the eager loop.  ``batched_microphysics`` and
``mp_driver_3d`` called on their own replay a CUDA graph of the call
(``kid_tpu_torch/micro/graphs.py``), dropped after phases 5b and 8.

Phases 2, 2b, 2c, 2d, 2e, 2f and 2g print a SHA-256 digest (first 16 hex
digits) of each kernel's outputs on each batch, and a combined digest per
kernel (phase 2d's apart): the inputs are seeded and the kernels
deterministic,
so a change to a kernel that keeps its results bit for bit keeps the
digests.  The new phases print their seconds.

Every kernel's launch count is set to 0 just before each main path is
driven and read just after (the ranks of phase 6 count their own); the
kernels line adds each kernel's launches on every other path
(``launches_by_path``).  A replay of a captured step adds the launches
its capture recorded; the capture itself, and the warm-up step run before
it on a copy of the state, add none.  The line before the last two is
the card's name and power limit, then one JSON line describing every
kernel, then ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent

# f32 peak outside the tensor cores and memory rate of an H100 SXM
# (NVIDIA data sheet), used for the kernel's bound
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12

# sizes of the phases (columns)
BATCH_NCOL = 1000      # kernel vs plain; not a multiple of any block
MAIN_NX = 8192         # the main path, mixed1 widened
E2E_NX = 256           # end-to-end parity
# main-path steps: spin-up, then timed windows
N_SPIN, N_TIMED, N_WINDOW = 150, 50, 10
# (nz, dtype) of the kernel-vs-plain batches of phases 2 and 2c
VS_PLAIN = [(120, torch.float64), (120, torch.float32),
            (130, torch.float64), (130, torch.float32),
            (33, torch.float64), (64, torch.float64), (97, torch.float64),
            (256, torch.float64)]
# phase 2d: the 2-D cases' nz, blocks of 64 threads, in both dtypes; its
# digests print apart, so that phase 2's combined digest repeats
VS_PLAIN_2D = [(60, torch.float64), (60, torch.float32)]
# phase 5b: the WRF-shaped (i, k, j) tile, 8192 columns as in phase 3
WRF_TILE = (128, 120, 64)
# phase 5: windows of the 2-D runs (steps per window)
N_WINDOW_2D = 90
# phase 6: ranks on the one card; the flagship (bench_scaling_r05.py:38)
N_RANKS = 2
FLAGSHIP_NX, FLAGSHIP_SPIN, FLAGSHIP_STEPS = 131072, 150, 20
# phase 2f: the transport kernel's cells: label -> (case, columns, the
# rank of 2 whose block it takes, or None); the loops' cells are timed
# against their targets (ms/launch)
ADVECT_CELLS = {"mixed1": ("mixed1", MAIN_NX, None),
                "warm1": ("warm1", MAIN_NX, None),
                "aerosol1d": ("aerosol1d", MAIN_NX, None),
                "cumulus2d": ("cumulus2d", FLAGSHIP_NX, None),
                "orographic2d": ("orographic2d", 64, None),
                "cumulus2d rank 1 of 2": ("cumulus2d", FLAGSHIP_NX, 1)}
ADVECT_TARGETS = {"mixed1": 0.06, "cumulus2d": 0.40}
# phase 9: cell -> (steps, from step (0: the initial sounding; else a
# seeded state), streams of the timed runs (True: all), streams of one
# more pair of runs or None); the 1-D cells at MAIN_NX columns, the
# flagship at FLAGSHIP_NX
GRAPH_CELLS = {
    "mixed1": (20, 150, (), True), "aerosol1d": (20, 150, (), True),
    "fused driver": (20, 150, (), True), "cumulus2d": (900, 0, True, None),
    "orographic2d": (900, 0, True, None),
    "flagship": (20, 150, (), ("qc", "qr", "prr_wau", "dqr_mphys"))}
# phase 9 on N_RANKS ranks: cell -> (steps, from step, streams, warm-up
# steps run first and discarded, the capture among them)
GRAPH_RANK_CELLS = {"cumulus2d": (900, 0, True, 20),
                    "flagship": (20, 150, ("prr_wau", "dqr_mphys"), 20)}
N_PROFILED = 5         # steps under the profiler
# phase 9: cells whose eager loop is profiled in two windows, their
# kernels a step compared (ROADMAP Queue 3 (b))
TWO_WINDOWS = ("aerosol1d",)
# phase 7: the cases that also run the perturbed (chaos) member, those
# of the reference's chaos envelope (VALIDATION_r05.json)
CHAOS_CASES = ("mixed1", "deep1", "aerosol1d")
# phase 5b: batched_microphysics cells -> (aerosol-aware, rate profiles,
# the kernels of a call)
BATCHED_CELLS = {"mixed": (False, False, ("table_stage", "fused_step")),
                 "mixed, rates": (False, True, ("table_stage", "fused_step")),
                 "aerosol": (True, False, ("table_stage", "fused_rates",
                                           "lookup_stage", "fused_post"))}
# phase 10: steps of the 1-D cases; (columns, steps) of the 2-D cases
ORACLE_STEPS = 100
ORACLE_2D = (16, 50)
# phase 11: steps of the CLI's first run; the resumed run doubles them
CLI_STEPS = 50
# phase 12: steps of the chaos member; steps of the --record runs
CHAOS_STEPS = 200
RECORD_STEPS = 20
# phase 9: the cells whose eager and graphed kernels are listed by name
# (ROADMAP Queue 3 (c))
KERNEL_DIFF_CELLS = ("cumulus2d", "orographic2d")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def equiv_report(got: dict, want: dict, noise: float) -> float:
    """The knife-edge tolerance model of tests/test_pallas.py::
    _assert_equiv with noise threshold ``noise``: at most 0.5% of cells
    over it and 0.2% regime flips (> 25%) per field; raises otherwise.
    Returns the worst normalised error outside counted flips."""
    parent = {"nc": "qc", "ni": "qi", "nr": "qr"}
    worst = 0.0
    for k, bt in want.items():
        a = got[k].double().cpu().numpy()
        b = bt.double().cpu().numpy()
        if k in parent and parent[k] in want:
            pa = got[parent[k]].double().cpu().numpy()
            pb = want[parent[k]].double().cpu().numpy()
            ghost = (np.abs(pa) < 1e-9) & (np.abs(pb) < 1e-9)
            a = np.where(ghost, 0.0, a)
            b = np.where(ghost, 0.0, b)
        scale = np.abs(b) + 1e-3 * np.abs(b).max() + 1e-30
        rel = np.abs(a - b) / scale
        if not np.isfinite(a).all():
            raise AssertionError(f"{k}: non-finite kernel output")
        n_noise = int((rel > noise).sum())
        n_flip = int((rel > 0.25).sum())
        if n_noise > max(3, 0.005 * rel.size):
            raise AssertionError(f"{k}: {n_noise} cells over {noise:g}")
        if n_flip > max(2, 0.002 * rel.size):
            raise AssertionError(f"{k}: {n_flip} flipped cells")
        worst = max(worst, float(np.sort(rel.ravel())[-1 - n_flip]))
    return worst


def digest(tensors) -> str:
    """First 16 hex digits of the SHA-256 of ``tensors``' bytes, in
    order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def record_digest(digests: dict, kernel: str, label: str,
                  outputs: dict) -> str:
    """Adds the digest of ``outputs`` to ``digests`` (kernel -> [(batch
    label, digest)]) and returns it."""
    d = digest(outputs.values())
    digests.setdefault(kernel, []).append((label, d))
    return d


def print_digests(digests: dict, *names):
    """One combined digest per kernel over its batches' digests."""
    for name in names:
        rows = digests.get(name, [])
        combined = hashlib.sha256("\n".join(
            f"{k}={d}" for k, d in rows).encode()).hexdigest()[:16]
        print(f"digests {name}: {len(rows)} batches, combined {combined}",
              flush=True)


def make_batch(ncol, nz, seed, dtype, dev, cold=False):
    """Seeded synthetic columns (tests/test_pallas.py::_make_batch).
    ``cold``: 20 K colder, down to 200 K, with the air above the 250 K
    level at 1.45 times ice saturation (DeMott and Koop nucleation)."""
    from kid_tpu_torch.micro.state import ColumnState
    from kid_tpu_torch.special import rsif_np
    rng = np.random.default_rng(seed)
    zc = (np.arange(nz) + 0.5) * (12000.0 / nz)
    p = 101325.0 * np.exp(-zc / 8500.0)
    t = np.maximum(288.0 - 0.0065 * zc, 210.0)
    qv = 0.012 * np.exp(-zc / 2500.0)
    if cold:
        t = np.maximum(268.0 - 0.0065 * zc, 200.0)
        qv = np.where(t < 250.0, 1.45 * rsif_np(p, t), qv)
    rho = 0.622 * p / (287.04 * t * (qv + 0.622))

    def b(x, scale=1.0):
        arr = np.broadcast_to(x, (ncol, nz)).copy()
        arr *= (1.0 + 0.2 * rng.random((ncol, 1)))
        return torch.tensor(np.maximum(arr * scale, 0.0), dtype=dtype,
                            device=dev)

    cloud = np.where((zc > 500) & (zc < 3000), 1.0e-3, 0.0)
    rain = np.where(zc < 2000, 3.0e-4, 0.0)
    ice = np.where(zc > 6000, 5.0e-5, 0.0)
    snow = np.where(zc > 5000, 2.0e-4, 0.0)
    state = ColumnState(
        t=b(t), qv=b(qv), qc=b(cloud), qi=b(ice), qr=b(rain), qs=b(snow),
        qg=b(snow, 0.5), ni=b(np.where(ice > 0, 1.0e4, 0.0)),
        nr=b(np.where(rain > 0, 1.0e5, 0.0)), nc=b(100.0e6 / rho),
        nwfa=b(300.0e6 / rho), nifa=b(1.0e6 / rho))
    pres = torch.tensor(np.broadcast_to(p, (ncol, nz)).copy(), dtype=dtype,
                        device=dev)
    dzq = torch.full((ncol, nz), 12000.0 / nz, dtype=dtype, device=dev)
    return state, pres, dzq


def flat(res):
    st, ppt, diag = res
    out = {f: getattr(st, f) for f in st._fields}
    out.update({f"ppt_{f}": getattr(ppt, f) for f in ppt._fields})
    out.update(diag)
    return out


PPT = ("ppt_rain", "ppt_snow", "ppt_graupel", "ppt_ice")


def phase_kernel_vs_plain(dev, digests, shapes=VS_PLAIN, key="fused_step"):
    """``fused_step`` against its plain version on the seeded batches of
    ``shapes``, digests recorded and printed under ``key``."""
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.micro.fused_step import fused_step, fused_step_ref
    from kid_tpu_torch.tables.cache import get_tables
    for nz, dtype in shapes:
        for cfg in (MicroConfig(iiwarm=False), MicroConfig(iiwarm=True)):
            tables = S.device_tables(get_tables(iiwarm=cfg.iiwarm), dtype,
                                     dev)
            st, pres, dzq = make_batch(BATCH_NCOL, nz, 0, dtype, dev)
            pro, idx = S._prologue(st, pres, cfg)
            tv = S._table_stage(pro, idx, tables, cfg, 10.0)
            for want_rates in (True, False):
                got = fused_step(st, pres, dzq, tv, cfg, 10.0, want_rates)
                ref = fused_step_ref(st, pres, dzq, tv, cfg, 10.0,
                                     want_rates)
                torch.cuda.synchronize()
                noise = 1e-9 if dtype == torch.float64 else 1e-3
                worst = equiv_report(flat(got), flat(ref), noise)
                label = (f"nz={nz} {'warm ' if cfg.iiwarm else 'mixed'} "
                         f"{str(dtype)[6:]} rates={int(want_rates)}")
                d = record_digest(digests, key, label, flat(got))
                print(f"kernel vs plain  {label}: worst normalised error "
                      f"{worst:.3e} (limit {noise:g}), digest {d}",
                      flush=True)
    print_digests(digests, key)


def kid_step_inputs(case, dtype, dev, istep=150):
    """A seeded driver state of ``case``, m(t) at ``istep`` and the
    table-stage channels built from the driver's provisional state (which
    advects ``advected_fields`` only), as the fused driver's step does."""
    from kid_tpu_torch.driver.advection import (advective_tendency_z,
                                                divergence_tendency_z)
    from kid_tpu_torch.driver.loop import KidState, advected_fields
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.micro.state import ColumnState
    from kid_tpu_torch.tables.cache import get_tables
    grid, cfg = case.grid(), case.micro
    st = KidState(*[t.to(dtype) for t in seeded_state(case, dev)])
    # m in float64 for every dtype: phase 2c's inputs, and so its digests,
    # do not depend on how the driver rounds m
    m = case.time_modulation(istep, torch.float64)

    def prof(a):
        return torch.tensor(np.array(a), dtype=dtype, device=dev)

    w_pat = prof(case.rhow_pattern(grid))
    rho0, dz = prof(grid.rho0), prof(grid.dz)
    prov = st._asdict()
    for f in advected_fields(cfg):
        q = prov[f]
        ten = (advective_tendency_z(q, m * w_pat, rho0, dz)
               + divergence_tendency_z(q, m * w_pat, rho0, dz))
        prov[f] = q + ten * case.dt
    micro_in = ColumnState(t=prov["theta"] * prof(grid.exner)[None, :],
                           **{f: prov[f] for f in ColumnState._fields[1:]})
    tables = S.device_tables(get_tables(iiwarm=cfg.iiwarm), dtype, dev)
    pro, idx = S._prologue(micro_in, prof(grid.pres).expand(case.nx, -1),
                           cfg)
    tv = S._table_stage(pro, idx, tables, cfg, case.dt)
    profs = (w_pat[0], prof(grid.pres), prof(grid.exner), rho0, dz)
    return st, m, tv, profs


def phase_kid_step_vs_plain(dev, digests):
    from kid_tpu_torch.driver.cases import MIXED1, WARM1_RECON
    from kid_tpu_torch.micro.fused_kid_step import (fused_kid_step,
                                                    fused_kid_step_ref)
    for nz, dtype in VS_PLAIN:
        for base in (MIXED1, WARM1_RECON):
            case = dataclasses.replace(base, nx=BATCH_NCOL, nz=nz)
            st, m, tv, (w, p, e, r, dz) = kid_step_inputs(case, dtype, dev)
            noise = 1e-9 if dtype == torch.float64 else 1e-3
            # the kernel reads m from the card, in the state's dtype
            m_dev = torch.tensor(m, dtype=dtype, device=dev)
            for want_rates in (True, False):
                args = (st, w, m_dev, tv, p, e, r, dz, case.micro, case.dt,
                        want_rates)
                got = fused_kid_step(*args)
                ref = fused_kid_step_ref(*args)
                torch.cuda.synchronize()
                worst = equiv_report(flat(got), flat(ref), noise)
                label = (f"nz={nz} "
                         f"{'warm ' if case.micro.iiwarm else 'mixed'} "
                         f"{str(dtype)[6:]} rates={int(want_rates)}")
                d = record_digest(digests, "fused_kid_step", label,
                                  flat(got))
                print(f"fused_kid_step vs plain  {label} m={m:.4f}: worst "
                      f"normalised error {worst:.3e} (limit {noise:g}), "
                      f"rain {float(got[1].rain.sum()):.3e}, digest {d}",
                      flush=True)
    print_digests(digests, "fused_kid_step")


def seeded_w(ncol, nz, seed, dtype, dev):
    """Seeded cell-centred vertical velocity (m/s) for activation."""
    rng = np.random.default_rng(seed + 100)
    return torch.tensor(rng.uniform(0.01, 4.0, (ncol, nz)), dtype=dtype,
                        device=dev)


def split_vs_plain(st, pres, dzq, w, cfg, tables, want_rates, noise,
                   digests, label):
    """``fused_rates`` and ``fused_post`` against their plain versions;
    ``fused_post`` gets the plain path's own p8 and lookups.  Records both
    kernels' digests under ``label``.  Returns the two worst normalised
    errors and the kernel's p8."""
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.micro import split_step as A
    pro, idx = S._prologue(st, pres, cfg)
    tv = S._table_stage(pro, idx, tables, cfg, 10.0)
    p8_k = A.fused_rates(st, pres, tv, cfg, 10.0, want_rates)
    p8 = A.fused_rates_ref(st, pres, tv, cfg, 10.0, want_rates)
    torch.cuda.synchronize()
    worst_r = equiv_report(p8_k, p8, noise)
    aux = S.aerosol_lookup_stage(st, pres, w, p8, tables, cfg, 10.0)
    got = A.fused_post(st, pres, dzq, p8, aux, cfg, 10.0, want_rates)
    ref = A.fused_post_ref(st, pres, dzq, p8, aux, cfg, 10.0, want_rates)
    torch.cuda.synchronize()
    record_digest(digests, "fused_rates", label, p8_k)
    record_digest(digests, "fused_post", label, flat(got))
    return worst_r, equiv_report(flat(got), flat(ref), noise), p8_k


def phase_split_vs_plain(dev, digests):
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.tables.cache import get_tables
    for nz in (120, 130):
        for warm in (False, True):
            cfg = MicroConfig(iiwarm=warm, is_aerosol_aware=True)
            for dtype in (torch.float64, torch.float32):
                tables = S.device_tables(get_tables(iiwarm=warm), dtype, dev)
                st, pres, dzq = make_batch(BATCH_NCOL, nz, 0, dtype, dev)
                w = seeded_w(BATCH_NCOL, nz, 0, dtype, dev)
                noise = 1e-9 if dtype == torch.float64 else 1e-3
                for want_rates in (True, False):
                    label = (f"nz={nz} {'warm ' if warm else 'mixed'} "
                             f"{str(dtype)[6:]} rates={int(want_rates)}")
                    wr, wp, _ = split_vs_plain(st, pres, dzq, w, cfg, tables,
                                               want_rates, noise, digests,
                                               label)
                    print(f"aerosol kernels vs plain  {label}: worst "
                          f"normalised error fused_rates {wr:.3e}, "
                          f"fused_post {wp:.3e} (limit {noise:g}), digests "
                          f"{digests['fused_rates'][-1][1]} "
                          f"{digests['fused_post'][-1][1]}", flush=True)
    # a cold batch: DeMott nucleation and the aerosol tendencies must fire
    cfg = MicroConfig(iiwarm=False, is_aerosol_aware=True)
    tables = S.device_tables(get_tables(iiwarm=False), torch.float64, dev)
    st, pres, dzq = make_batch(BATCH_NCOL, 120, 1, torch.float64, dev,
                               cold=True)
    w = seeded_w(BATCH_NCOL, 120, 1, torch.float64, dev)
    wr, wp, p8 = split_vs_plain(st, pres, dzq, w, cfg, tables, True, 1e-9,
                                digests, "cold nz=120 mixed float64 rates=1")
    counts = {k: int(v.sum()) for k, v in (
        ("pri_inu>0", p8["pri_inu"] > 0), ("pni_inu>0", p8["pni_inu"] > 0),
        ("nwfaten!=0", p8["nwfaten"] != 0),
        ("nifaten!=0", p8["nifaten"] != 0),
        ("T<238K", st.t < 238.0))}
    print(f"aerosol kernels vs plain, cold batch ({BATCH_NCOL}, 120) f64: "
          f"worst normalised error fused_rates {wr:.3e}, fused_post {wp:.3e} "
          f"(limit 1e-9); cells of {BATCH_NCOL * 120}: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    if min(counts.values()) == 0:
        raise AssertionError(f"cold batch: a process did not fire {counts}")
    print_digests(digests, "fused_rates", "fused_post")


class OpCounter(TorchDispatchMode):
    """Counts the elementwise arithmetic, comparison, selection and
    transcendental operations (output elements) of the ops it sees."""

    NAMES = {"add", "sub", "rsub", "mul", "div", "neg", "exp", "log",
             "log10", "sqrt", "rsqrt", "pow", "maximum", "minimum", "clamp",
             "clamp_min", "clamp_max", "where", "gt", "lt", "ge", "le",
             "eq", "ne", "abs", "sign", "floor", "reciprocal",
             "logical_and", "logical_or", "logical_not", "bitwise_and",
             "bitwise_or", "bitwise_not", "sin"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in self.NAMES:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.ops += t.numel()
        return out


def phase_resources():
    """What the card gives every kernel instantiation at the block sizes
    of nz 120 and 256.  Returns the main-path float32 instantiation's
    resources by kernel (mixed phase, nz 120, no rate profiles)."""
    from kid_tpu_torch.micro import cuda_build
    main = {}
    for nz in (60, 120, 130):
        for dtype in (torch.float32, torch.float64):
            for n_adv in (5, 9, 12):
                for two_d in (False, True):
                    r = cuda_build.resources("advect", nz, dtype, n_adv,
                                             two_d)
                    print(f"resources advect nz={nz} {str(dtype)[6:]} "
                          f"n_adv={n_adv} {'2-D' if two_d else '1-D'}: "
                          f"{r['regs']} regs, {r['spill_bytes']} spill "
                          f"bytes, {r['shared_bytes']} shared bytes, "
                          f"{r['blocks_per_sm']} blocks of 256 threads/SM",
                          flush=True)
                    if (nz, dtype, n_adv, two_d) == (120, torch.float32, 9,
                                                     False):
                        main["advect"] = r
    for name in kernels():
        if name == "advect":
            continue
        # lookup_stage has no flag: its blocks take 256 cells at any nz
        flags = (False,) if name == "lookup_stage" else (False, True)
        for nz in (120, 256):
            for dtype in (torch.float32, torch.float64):
                for warm in (False, True):
                    for want_rates in flags:
                        r = cuda_build.resources(name, nz, dtype, warm,
                                                 want_rates)
                        warps = r["blocks_per_sm"] * ((nz + 31) // 32)
                        # table_stage has no rate profiles: its flag is
                        # the aerosol-aware instantiation
                        flag = "aero" if name == "table_stage" else "rates"
                        print(f"resources {name} nz={nz} {str(dtype)[6:]} "
                              f"{'warm ' if warm else 'mixed'} "
                              f"{flag}={int(want_rates)}: {r['regs']} regs, "
                              f"{r['spill_bytes']} spill bytes, "
                              f"{r['shared_bytes']} static shared bytes, "
                              f"{r['blocks_per_sm']} blocks/SM ({warps} "
                              f"warps/SM)", flush=True)
                        if (nz, dtype, warm, want_rates) == (
                                120, torch.float32, False, False):
                            main[name] = r
    return main


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernels():
    """Every kernel wrapper of the port by name (each has a launch count)."""
    from kid_tpu_torch.micro import cuda_build
    return cuda_build.wrappers()


def reset_counts():
    from kid_tpu_torch.micro import cuda_build
    cuda_build.reset_launch_counts()


def read_counts() -> dict:
    from kid_tpu_torch.micro import cuda_build
    return cuda_build.launch_counts()


def recording(packers):
    """Replace each (module, name) packer by one that keeps its last
    output in the returned dict; returns (dict, restore)."""
    last, originals = {}, []
    for mod, name in packers:
        fn = getattr(mod, name)
        originals.append((mod, name, fn))

        def rec(*args, _fn=fn, _name=name):
            last[_name] = _fn(*args)
            return last[_name]
        setattr(mod, name, rec)

    def restore():
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return last, restore


def first_graphed_call(simulate, dev, st0, tables, case):
    """The first step of ``case`` from ``st0`` in a call of its own, which
    warms up and captures the step before it replays it: (host ms of the
    call, the state after it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = simulate(st0, tables, case, 1, device=dev)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, st


def kept_inputs(last: dict) -> dict:
    """Copies of the packers' last outputs.  In a graphed run those are the
    captured graph's own buffers, which each replay fills with its step's
    input: copied just after a run, they are its last step's inputs."""
    return {k: tuple(t.clone() for t in v) if isinstance(v, tuple)
            else v.clone() for k, v in last.items()}


def run_main_path(dev, card, case, path_kernels, packers):
    """Spin-up, then 50 timed steps of ``case`` at full width in float32
    with every launch count set to 0 just before and read just after;
    checks the outputs and that each kernel of ``path_kernels`` launched
    once per step (and no other kernel launched).  ``packers`` are
    (module, function name) of the kernels' input packers: the last timed
    step's input of each is kept.  The spin-up captures the step; the
    timed windows replay it.  Returns (launch counts, last inputs by
    packer, median ms/step)."""
    from kid_tpu_torch.driver.loop import initial_state, simulate
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables

    dtype = torch.float32
    n_spin, n_timed, n_window = N_SPIN, N_TIMED, N_WINDOW
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype, dev)
    last, restore = recording(packers)
    window_ms, ppts = [], []
    try:
        first_ms, final = first_graphed_call(simulate, dev, initial_state(
            case, dtype, dev), tables, case)
        t0 = time.perf_counter()
        final, _ = simulate(final, tables, case, n_spin - 1, istep0=1,
                            device=dev)
        torch.cuda.synchronize()
        print(f"main path {case.name} spin-up: the first call (warm-up, "
              f"capture and 1 step) {first_ms:.1f} ms, then {n_spin - 1} "
              f"steps in {time.perf_counter() - t0:.1f} s", flush=True)
        reset_counts()
        for w in range(n_timed // n_window):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            final, out = simulate(final, tables, case, n_window,
                                  istep0=n_spin + w * n_window, device=dev)
            e1.record()
            torch.cuda.synchronize()
            window_ms.append(e0.elapsed_time(e1) / n_window)
            ppts.append(out)
        counts = read_counts()
        inputs = kept_inputs(last)
    finally:
        restore()
    step_ms = float(np.median(window_ms))
    for k, n in counts.items():
        want = n_timed if k in path_kernels else 0
        if n != want:
            raise AssertionError(f"{case.name}: {n} {k} launches in "
                                 f"{n_timed} steps, expected {want}")
    check_finite_nonnegative(case.name, final._asdict())
    rain = 0.0
    for out in ppts:
        check_finite_nonnegative(case.name,
                                 {k: getattr(out, k) for k in PPT})
        rain += float(out.ppt_rain.sum())
    best_ms = min(window_ms)
    launches = ", ".join(f"{counts[k]} {k}" for k in path_kernels)
    print(f"main path {case.name} ({case.nx}, {case.nz}) f32, "
          f"{len(window_ms)} windows of {n_window} steps: median "
          f"{step_ms:.3f} ms/step ({case.nx * 1e3 / step_ms:.0f} "
          f"column-steps/s), best {best_ms:.3f} ms/step "
          f"({case.nx * 1e3 / best_ms:.0f} column-steps/s), windows "
          f"{' '.join(f'{m:.3f}' for m in window_ms)} ms/step; "
          f"launches in {n_timed} steps: {launches}; "
          f"qc max {float(final.qc.max()):.3e}, qs max "
          f"{float(final.qs.max()):.3e}, nwfa min "
          f"{float(final.nwfa.min()):.3e}, rain in the timed steps "
          f"{rain:.3e} [{card}]", flush=True)
    profile_steps(dev, card, final, tables, case, n_spin + n_timed, step_ms,
                  path_kernels)
    return counts, inputs, step_ms


def kernel_record(name, card, x, launch, plain, n_out_bytes, launches,
                  got_want, res, where="the main path's input"):
    """Time ``launch`` (the kernel) and ``plain`` (its plain version) on
    the main path's input ``x`` (a packed tensor, or a tuple of them),
    bound the work, check the two agree under the f32 knife-edge model;
    returns the kernels-line record, with ``res``, the resources of the
    kernel's main-path instantiation (phase 1).  ``where`` names the input
    in the printed line."""
    got, want = got_want()
    worst = equiv_report(got, want, 1e-3)
    max_abs = max(float((got[k] - want[k]).abs().max()) for k in want)
    ms = time_ms(launch, 50)
    plain_ms = time_ms(plain, 5)
    counter = OpCounter()
    with counter:
        plain()
    ins = x if isinstance(x, tuple) else (x,)
    x = ins[0]
    n_bytes = sum(t.numel() * t.element_size() for t in ins) + n_out_bytes
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    ops_ms = counter.ops / PEAK_F32_OPS * 1e3
    print(f"{name} at {where} {tuple(x.shape[1:])} f32: "
          f"{ms:.4f} ms/launch, plain version {plain_ms:.3f} ms, bound "
          f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes / 1e6:.1f} MB -> "
          f"{bytes_ms:.4f} ms, {counter.ops / 1e9:.2f} G elementwise ops "
          f"-> {ops_ms:.4f} ms), worst normalised error {worst:.3e} "
          f"(limit 1e-3), max abs error {max_abs:.3e} [{card}]",
          flush=True)
    return dict(
        name=name, route="cuda",
        source=f"kid_tpu_torch/micro/csrc/{name}.cu",
        replaces=REPLACES[name],
        launches=launches, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, regs=res["regs"], spill_bytes=res["spill_bytes"],
        blocks_per_sm=res["blocks_per_sm"])


# what each kernel replaces: the def line of a TPU kernel in
# kid_tpu/micro/pallas_step.py, or the reference's XLA stages
REPLACES = {"table_stage": "kid_tpu/micro/solver.py:1132,1350",
            "advect": "kid_tpu/driver/loop.py:230-262 (XLA's fusion)",
            "lookup_stage": "kid_tpu/micro/solver.py::aerosol_lookup_stage "
                            "(XLA's fusion)",
            **{k: f"kid_tpu/micro/pallas_step.py:{v}" for k, v in (
                ("fused_step", 353), ("fused_rates", 202),
                ("fused_post", 266), ("fused_kid_step", 67))}}
# the kernels of a solver or WRF-shaped call, and of each step path, each
# launched once a call or a step
CALL = ("table_stage", "fused_step")
STEP = ("advect", *CALL)
SPLIT = ("advect", "table_stage", "fused_rates", "lookup_stage",
         "fused_post")
KID = ("advect", "table_stage", "fused_kid_step")


def path_counts(counts, n, kernels) -> dict:
    """``counts``' kernels with ``n`` launches for those of ``kernels``
    and 0 for the others: what a path of ``kernels`` launches in ``n``
    steps."""
    return {k: n if k in kernels else 0 for k in counts}


def phase_main_path(dev, card, res):
    import kid_tpu_torch.micro.fused_step as F
    from kid_tpu_torch.driver.cases import MIXED1
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.micro.state import ColumnState

    case = dataclasses.replace(MIXED1, nx=MAIN_NX)
    counts, last, step_ms = run_main_path(dev, card, case, STEP,
                                          [(F, "pack_inputs")])

    # the kernel and its plain version on the main path's last input
    x = last["pack_inputs"]
    cfg, dt_f = case.micro, case.dt
    st_in = ColumnState(*x[:12])
    tv = dict(zip(S.tv_keys(cfg), x[14:]))
    ncol, nz = x.shape[1:]
    out_bytes = (12 * ncol * nz + 4 * ncol) * x.element_size()

    def got_want():
        y, ppt = F.launch_packed(x, cfg, dt_f, False)
        ref = F.fused_step_ref(st_in, x[12], x[13], tv, cfg, dt_f, False)
        torch.cuda.synchronize()
        return flat(F.unpack_outputs(y, ppt, False)), flat(ref)

    return [kernel_record(
        "fused_step", card, x, lambda: F.launch_packed(x, cfg, dt_f, False),
        lambda: F.fused_step_ref(st_in, x[12], x[13], tv, cfg, dt_f, False),
        out_bytes, counts["fused_step"], got_want, res["fused_step"])], \
        step_ms, counts, x


def phase_fused_driver_main_path(dev, card, default_ms, res):
    import kid_tpu_torch.micro.fused_kid_step as FK
    from kid_tpu_torch.driver.cases import MIXED1
    from kid_tpu_torch.driver.loop import FUSED_DRIVER_ENV, KidState
    from kid_tpu_torch.micro import solver as S

    case = dataclasses.replace(MIXED1, nx=MAIN_NX)
    os.environ[FUSED_DRIVER_ENV] = "1"
    try:
        counts, last, step_ms = run_main_path(
            dev, card, case, KID, [(FK, "pack_kid_inputs")])
    finally:
        del os.environ[FUSED_DRIVER_ENV]
    print(f"fused driver mixed1 ({case.nx}, {case.nz}) f32: median "
          f"{step_ms:.3f} ms/step against {default_ms:.3f} ms/step of the "
          f"default path (phase 3, same call) [{card}]", flush=True)

    # the kernel and its plain version on the main path's last input,
    # the last timed step's
    x, prof = last["pack_kid_inputs"]
    cfg, dt_f = case.micro, case.dt
    m = torch.tensor(case.time_modulation(N_SPIN + N_TIMED - 1, x.dtype),
                     dtype=x.dtype, device=x.device)
    ncol, nz = x.shape[1:]
    st_in = KidState(*x[:12])
    tv = dict(zip(S.tv_keys(cfg), x[12:]))
    rows = (prof[0], *prof[1:, :nz])
    out_bytes = (12 * ncol * nz + 4 * ncol) * x.element_size()

    def plain():
        return FK.fused_kid_step_ref(st_in, rows[0], m, tv, *rows[1:], cfg,
                                     dt_f, False)

    def got_want():
        y, ppt = FK.launch_kid_packed(x, prof, m, cfg, dt_f, False)
        ref = plain()
        torch.cuda.synchronize()
        return flat(FK.unpack_kid_outputs(y, ppt, False)), flat(ref)

    return [kernel_record(
        "fused_kid_step", card, (x, prof),
        lambda: FK.launch_kid_packed(x, prof, m, cfg, dt_f, False), plain,
        out_bytes, counts["fused_kid_step"], got_want,
        res["fused_kid_step"])], counts


def phase_aerosol_main_path(dev, card, res):
    import kid_tpu_torch.micro.split_step as A
    from kid_tpu_torch.driver.cases import AEROSOL1D
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.micro.state import ColumnState

    case = dataclasses.replace(AEROSOL1D, nx=MAIN_NX)
    counts, last, _ = run_main_path(
        dev, card, case, SPLIT,
        [(A, "pack_rates_inputs"), (A, "pack_post_inputs")])
    cfg, dt_f = case.micro, case.dt
    records = []

    # kernel A on its last input
    xa = last["pack_rates_inputs"]
    ncol, nz = xa.shape[1:]
    st_a = ColumnState(*xa[:12])
    tv = dict(zip(S.tv_keys(cfg), xa[13:]))

    def want_a():
        got = A.unpack_rates_outputs(
            A.launch_rates_packed(xa, cfg, dt_f, False), False)
        ref = A.fused_rates_ref(st_a, xa[12], tv, cfg, dt_f, False)
        torch.cuda.synchronize()
        return got, ref

    records.append(kernel_record(
        "fused_rates", card, xa,
        lambda: A.launch_rates_packed(xa, cfg, dt_f, False),
        lambda: A.fused_rates_ref(st_a, xa[12], tv, cfg, dt_f, False),
        len(S.P8_OUT) * ncol * nz * xa.element_size(),
        counts["fused_rates"], want_a, res["fused_rates"]))

    # kernel B on its last input
    xb = last["pack_post_inputs"]
    st_b = ColumnState(*xb[:12])
    p8 = dict(zip(S.P8_OUT, xb[14:14 + len(S.P8_OUT)]))
    aux = dict(zip(A.AUX_KEYS, xb[14 + len(S.P8_OUT):]))

    def want_b():
        y, ppt = A.launch_post_packed(xb, cfg, dt_f, False)
        ref = A.fused_post_ref(st_b, xb[12], xb[13], p8, aux, cfg, dt_f,
                               False)
        torch.cuda.synchronize()
        return flat(A.unpack_post_outputs(y, ppt, p8, False)), flat(ref)

    records.append(kernel_record(
        "fused_post", card, xb,
        lambda: A.launch_post_packed(xb, cfg, dt_f, False),
        lambda: A.fused_post_ref(st_b, xb[12], xb[13], p8, aux, cfg, dt_f,
                                 False),
        (12 * ncol * nz + 4 * ncol) * xb.element_size(),
        counts["fused_post"], want_b, res["fused_post"]))
    guard_shares(card, lambda: A.fused_rates_ref(st_a, xa[12], tv, cfg, dt_f,
                                                 False),
                 lambda: A.fused_post_ref(st_b, xb[12], xb[13], p8, aux, cfg,
                                          dt_f, False))
    return records, counts, xa


# phase 2e: the f64 batch's columns, and the 2-D cases' nz
TABLE_F64_NCOL, TABLE_2D_NZ = 256, 60
# phase 2g: aerosol1d's steps whose lookups are checked, the columns of
# its float32 and float64 runs there, and the widths timed (float32)
LOOKUP_STEPS = (0, 200, 700)
LOOKUP_NCOL = {torch.float32: MAIN_NX, torch.float64: 1024}
LOOKUP_TIMED_NX = (MAIN_NX, 65536)


def index_flips(got: dict, want: dict, noise: float) -> tuple:
    """The cells (column, level) where some tv channel's normalised error
    (as ``equiv_report`` normalises it) is over ``noise``: a lookup index
    that flipped at a knife edge.  Returns (their number, the channels
    over ``noise`` there)."""
    cells, chans = None, []
    for k, b in want.items():
        b = b.double()
        scale = b.abs() + 1e-3 * b.abs().max() + 1e-30
        over = (got[k].double() - b).abs() / scale > noise
        if bool(over.any()):
            chans.append(k)
        cells = over if cells is None else cells | over
    return int(cells.sum()), chans


def table_bytes(st, pres, tables, cfg) -> int:
    """The bytes of the table values that the table stage's data needs
    on these inputs: each distinct element read once, a gather counted
    only where its consumers' mask holds (the plain version's indices)."""
    from kid_tpu_torch import constants as c
    from kid_tpu_torch.micro import solver as S
    pro, idx = S._prologue(st, pres, cfg)
    esize = pres.element_size()
    n = torch.unique(idx["rw"] * c.NBC + idx["cw"]).numel()
    if cfg.iiwarm:
        return n * esize
    temp, rr, rs, rg, rc = (pro[k] for k in ("temp", "rr", "rs", "rg",
                                              "rc"))
    t_lt_0 = temp < c.T_0
    rr_on = rr >= S._RR1
    lin_s = ((idx["s"] * c.NTB_T + idx["t"]) * c.NTB_R1 + idx["r1"]) \
        * c.NTB_R + idx["r"]
    lin_g = ((idx["g1"] * c.NTB_G + idx["g"]) * c.NTB_R1 + idx["r1"]) \
        * c.NTB_R + idx["r"]
    lin_f = (idx["r"] * c.NTB_R1 + idx["r1"]) * 45 + idx["tc"]
    at_i = idx["i"] * c.NTB_I1 + idx["i1"]
    ice_on = t_lt_0 & (pro["qi1d"] > c.R1)
    for lin, mask, width in (
            (idx["sw"] * c.NBC + idx["cw"], None, 1),
            (lin_s, rr_on & (rs >= S._RS1), 5),
            (lin_g, rr_on & (rg >= S._RG1), 4),
            (lin_f, t_lt_0 & (rr > S._RR1), 4),
            (idx["c"] * 45 + idx["tc"], t_lt_0 & (rc > S._RC1), 2),
            (at_i, None, 1), (at_i, ice_on, 2)):
        sel = lin if mask is None else lin[mask]
        n += torch.unique(sel).numel() * width
    return n * esize


def table_stage_vs_plain(label, st, pres, tables, cfg, dt_f, digests):
    """``table_stage`` against its plain version on one batch: f64 within
    1e-9 normalised, f32 under the knife-edge model at 1e-3, each outside
    the counted index flips, which are printed with the batch's digest.
    Returns the kernel's and the plain version's tv dicts."""
    import kid_tpu_torch.micro.table_stage as TS
    got = TS.table_stage(st, pres, tables, cfg, dt_f)
    want = TS.table_stage_ref(st, pres, tables, cfg, dt_f)
    torch.cuda.synchronize()
    noise = 1e-9 if st.qv.dtype == torch.float64 else 1e-3
    worst = equiv_report(got, want, noise)
    n_flip, chans = index_flips(got, want, noise)
    d = record_digest(digests, "table_stage", label, got)
    print(f"table_stage vs plain  {label}: worst normalised error "
          f"{worst:.3e} (limit {noise:g}) outside {n_flip} index-flip cells "
          f"of {st.qv.numel()}{' in ' + ', '.join(chans) if chans else ''}, "
          f"digest {d}", flush=True)
    return got, want


def warm1_inputs(dev):
    """warm1 widened to MAIN_NX columns in float32: 150 steps, then one
    step with the fused_step packer recorded (its first 13 rows are the
    table stage's input).  Returns the packed input."""
    import kid_tpu_torch.micro.fused_step as F
    from kid_tpu_torch.driver.cases import WARM1
    from kid_tpu_torch.driver.loop import run_case, simulate
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    case = dataclasses.replace(WARM1, nx=MAIN_NX)
    st, _ = run_case(case, torch.float32, n_steps=N_SPIN, device=dev)
    tables = device_tables(get_tables(iiwarm=True), torch.float32, dev)
    last, restore = recording([(F, "pack_inputs")])
    try:
        simulate(st, tables, case, 1, istep0=N_SPIN, device=dev,
                 graphs=False)
    finally:
        restore()
    return last["pack_inputs"]


def phase_table_stage(dev, card, digests, launches, x_mixed, x_aero):
    """``table_stage`` against its plain version: on the last inputs of
    mixed1's and aerosol1d's main paths and of warm1 at (MAIN_NX, 120)
    f32, each timed beside its plain version and bound; on a seeded
    (TABLE_F64_NCOL, 120) f64 batch (mixed, aerosol-aware, warm); at the
    2-D cases' nz in both dtypes (mixed, warm).  Returns the kernels-line
    record of mixed1's input, whose launches are ``launches``."""
    import kid_tpu_torch.micro.table_stage as TS
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.driver.cases import AEROSOL1D, MIXED1, WARM1
    from kid_tpu_torch.micro import cuda_build
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.micro.state import ColumnState
    from kid_tpu_torch.tables.cache import get_tables
    f32, f64 = torch.float32, torch.float64
    tabs = {(w, dt): S.device_tables(get_tables(iiwarm=w), dt, dev)
            for w in (False, True) for dt in (f32, f64)}
    record = None
    for case, x in ((MIXED1, x_mixed), (AEROSOL1D, x_aero),
                    (WARM1, warm1_inputs(dev))):
        cfg, dt_f = case.micro, case.dt
        st, pres = ColumnState(*x[:12]), x[12]
        tables = tabs[(cfg.iiwarm, f32)]
        ncol, nz = pres.shape
        label = f"{case.name}'s last input ({ncol}, {nz}) float32"
        table_stage_vs_plain(label, st, pres, tables, cfg, dt_f, digests)
        r = cuda_build.resources("table_stage", nz, f32, cfg.iiwarm,
                                 cfg.is_aerosol_aware)
        out = torch.empty((len(S.tv_keys(cfg)), ncol, nz), dtype=f32,
                          device=dev)
        chans = list(x[:13])
        # the table values these inputs need, each read once
        needed = torch.empty(table_bytes(st, pres, tables, cfg) // 4,
                             dtype=f32, device=dev)

        def got_want(st=st, pres=pres, tables=tables, cfg=cfg, dt_f=dt_f):
            got = TS.table_stage(st, pres, tables, cfg, dt_f)
            want = TS.table_stage_ref(st, pres, tables, cfg, dt_f)
            torch.cuda.synchronize()
            return got, want

        rec = kernel_record(
            "table_stage", card, (x[:13], needed),
            lambda chans=chans, tables=tables, out=out, cfg=cfg, dt_f=dt_f:
            TS.launch(chans, tables, out, cfg, dt_f),
            lambda st=st, pres=pres, tables=tables, cfg=cfg, dt_f=dt_f:
            TS.table_stage_ref(st, pres, tables, cfg, dt_f),
            out.numel() * out.element_size(), launches, got_want, r,
            f"{case.name}'s last input ({r['regs']} regs, "
            f"{r['spill_bytes']} spill bytes, {r['blocks_per_sm']} blocks "
            f"of {(nz + 31) // 32 * 32} threads/SM)")
        record = record or rec
    st, pres, _ = make_batch(TABLE_F64_NCOL, 120, 3, f64, dev)
    for cfg in (MicroConfig(iiwarm=False),
                MicroConfig(iiwarm=False, is_aerosol_aware=True),
                MicroConfig(iiwarm=True)):
        kind = ("warm" if cfg.iiwarm else "aerosol" if cfg.is_aerosol_aware
                else "mixed")
        table_stage_vs_plain(f"seeded ({TABLE_F64_NCOL}, 120) float64 "
                             f"{kind}", st, pres, tabs[(cfg.iiwarm, f64)],
                             cfg, 10.0, digests)
    for dtype in (f64, f32):
        st, pres, _ = make_batch(BATCH_NCOL, TABLE_2D_NZ, 0, dtype, dev)
        for warm in (False, True):
            table_stage_vs_plain(
                f"seeded ({BATCH_NCOL}, {TABLE_2D_NZ}) {str(dtype)[6:]} "
                f"{'warm' if warm else 'mixed'}", st, pres,
                tabs[(warm, dtype)], MicroConfig(iiwarm=warm), 10.0, digests)
    print_digests(digests, "table_stage")
    return record


def advect_inputs(cell, dtype, dev, seed=0):
    """(state, m, ``Transport``, n_adv) of an ``ADVECT_CELLS`` cell: the
    case's initial sounding with cloud layers and 5% of seeded noise on
    every channel, m(t) at step 150 and the flow of its columns, or of its
    rank's block, whose ``Halo`` holds the neighbours' edge columns as the
    ring exchange delivers them."""
    from kid_tpu_torch.dist import mesh as M
    from kid_tpu_torch.driver import advection as ADV
    from kid_tpu_torch.driver.cases import CASES
    from kid_tpu_torch.driver.loop import (KidState, advected_fields,
                                           build_flow, initial_state)
    name, ncol, rank = ADVECT_CELLS[cell]
    base = CASES[name]
    wide = {} if ncol == base.nx else (
        {"nx": ncol} if base.is_1d else {"nx": ncol, "cell_nx": base.nx})
    case = dataclasses.replace(base, **wide)
    gen = torch.Generator(device=dev).manual_seed(seed)
    grid = case.grid()

    def prof(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    layer = 1.0e-4 * (prof(grid.z) < 0.5 * case.ztop).to(dtype)
    st = []
    for f, t in zip(KidState._fields, initial_state(case, dtype, dev)):
        b = t + layer if f in ("qc", "qr", "qi", "qs") else t
        st.append(b * (1.0 + 0.05 * torch.randn(
            b.shape, generator=gen, dtype=dtype, device=dev)))
    n_adv = len(advected_fields(case.micro))
    lo, hi = (0, ncol) if rank is None else M.column_block(ncol, rank, 2)
    fl = build_flow(case, dtype, dev, lo, hi)
    ghosts = None
    if rank is not None:
        ghosts = M.Halo(case, dtype, dev)
        for buf, cols in ((ghosts.left, range(lo - M.HALO, lo)),
                          (ghosts.right, range(hi, hi + M.HALO))):
            idx = torch.tensor(cols, device=dev) % ncol
            buf.copy_(torch.stack([t[idx] for t in st[:n_adv]]))
    tr = ADV.Transport(fl.w_pat, fl.u_pat, prof(grid.rho0), prof(grid.dz),
                       prof(grid.exner)[None, :], fl.pres2, case.u0,
                       case.dx, case.dt, ghosts)
    m = torch.tensor(case.time_modulation(150, dtype), dtype=dtype,
                     device=dev)
    return KidState(*[t[lo:hi] for t in st]), m, tr, n_adv


def phase_advect(dev, card, digests, launches, res):
    """``advect`` (the driver step's transport) against its plain version
    on each ``ADVECT_CELLS`` cell in float32 and float64: every head row
    and the provisional theta bit for bit, a digest of each and a
    combined one; in float32 at the loops' shapes its ms/launch beside
    its bound (bytes: the state planes and flow rows read once, 14 rows
    written) and its target, and the plain composition's ms.  Returns the
    kernels-line record (mixed1's input; cumulus2d's beside it), whose
    launches are ``launches``."""
    from kid_tpu_torch.driver import advection as ADV
    from kid_tpu_torch.micro.state import ColumnState
    names = (*ColumnState._fields, "pres", "dzq", "provisional theta")
    record = {}
    for cell in ADVECT_CELLS:
        for dtype in (torch.float32, torch.float64):
            st, m, tr, n_adv = advect_inputs(cell, dtype, dev)
            shape = tuple(st.qv.shape)
            got = [torch.empty((14, *shape), dtype=dtype, device=dev),
                   torch.empty(shape, dtype=dtype, device=dev)]
            want = [torch.empty_like(t) for t in got]
            ADV.advect(st, m, tr, n_adv, *got)
            ADV.advect_ref(st, m, tr, n_adv, *want)
            torch.cuda.synchronize()
            got_rows = dict(zip(names, [*got[0], got[1]]))
            want_rows = dict(zip(names, [*want[0], want[1]]))
            bad = [k for k in names
                   if not torch.equal(got_rows[k], want_rows[k])]
            label = f"{cell} {shape} {str(dtype)[6:]}"
            d = record_digest(digests, "advect", label, got_rows)
            print(f"advect vs plain  {label}: {len(names) - len(bad)} of "
                  f"{len(names)} rows bit for bit, digest {d}", flush=True)
            if bad:
                worst = max(float((got_rows[k] - want_rows[k]).abs().max())
                            for k in bad)
                raise AssertionError(f"advect {label}: {bad} differ from "
                                     f"the plain version (worst {worst:.3e})")
            if dtype != torch.float32 or cell not in ADVECT_TARGETS:
                continue
            out = got[0]
            ms = time_ms(lambda: ADV.launch(st, m, tr, n_adv, out), 50)
            plain_ms = time_ms(
                lambda: ADV.advect_ref(st, m, tr, n_adv, out), 5)
            counter = OpCounter()
            with counter:
                ADV.advect_ref(st, m, tr, n_adv, out)
            flows = [tr.w_pat] + ([tr.u_pat] if tr.u_pat is not None else [])
            n_bytes = 4 * (12 * st.qv.numel() + sum(t.numel() for t in flows)
                           + out.numel())
            bytes_ms = n_bytes / PEAK_BYTES * 1e3
            ops_ms = counter.ops / PEAK_F32_OPS * 1e3
            bound = max(bytes_ms, ops_ms)
            target = ADVECT_TARGETS[cell]
            print(f"advect at {label}: {ms:.4f} ms/launch ({ms / bound:.2f}x "
                  f"its bound, target {target} ms), plain composition "
                  f"{plain_ms:.3f} ms, bound {bound:.4f} ms "
                  f"({n_bytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms, "
                  f"{counter.ops / 1e9:.2f} G elementwise ops of the plain "
                  f"version -> {ops_ms:.4f} ms) [{card}]", flush=True)
            record[cell] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                bound_by="bytes" if bytes_ms >= ops_ms
                                else "operations", shape=list(shape))
    print_digests(digests, "advect")
    main = record.pop("mixed1")
    return dict(name="advect", route="cuda",
                source="kid_tpu_torch/micro/csrc/advect.cu",
                replaces=REPLACES["advect"], launches=launches,
                max_abs_err=0.0, library_ms=None, regs=res["regs"],
                spill_bytes=res["spill_bytes"],
                blocks_per_sm=res["blocks_per_sm"], **main, also=record)


def lookup_step_inputs(case, dtype, dev, n_steps):
    """The lookup stage's arguments (state, pres, w, p8, tables, cfg, dt)
    in step ``n_steps`` of ``case`` from its initial sounding (graphed up
    to there, then that step eagerly, its lookup stage's arguments kept),
    and the step's dzq."""
    import kid_tpu_torch.micro.split_step as A
    from kid_tpu_torch.driver.loop import initial_state, run_case, simulate
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.micro.state import ColumnState
    from kid_tpu_torch.tables.cache import get_tables
    st = (initial_state(case, dtype, dev) if n_steps == 0 else
          run_case(case, dtype, n_steps=n_steps, device=dev)[0])
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype, dev)
    kept, last = A.lookup_stage, {}

    def rec(*args, **kwargs):
        last["args"] = args
        return kept(*args, **kwargs)
    rec.launches = kept.launches        # the launch counts on the module's
    A.lookup_stage = rec
    try:
        simulate(st, tables, case, 1, istep0=n_steps, device=dev,
                 graphs=False)
    finally:
        A.lookup_stage = kept
        kept.launches = rec.launches
    state, pres, w, p8, tables, cfg, dt_f = last["args"]
    dzq = torch.broadcast_to(torch.as_tensor(
        case.grid().dz, dtype=dtype, device=dev), state.qv.shape)
    return (ColumnState(*[t.clone() for t in state]), pres.clone(),
            w.clone(), {k: v.clone() for k, v in p8.items()}, tables, cfg,
            dt_f), dzq


def cold_lookup_inputs(dtype, dev, ncol=BATCH_NCOL, nz=40):
    """The lookup stage's arguments on a cold column where DeMott's and
    Koop's nucleation fire (the recipe of kidbench/tests/
    test_kidbench_reference.py::cold_column: 262 K down to 212 K, 50% over
    ice saturation, a little of every species), tiled over ``ncol``
    columns with 20% of seeded noise a column, p8 from the plain
    ``fused_rates`` with its rates; and its dzq and p8's ``pni_inu``."""
    import kid_tpu_torch.micro.split_step as A
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.micro import solver as S
    from kid_tpu_torch.micro.state import ColumnState
    from kid_tpu_torch.tables.cache import get_tables
    rng = np.random.default_rng(4)
    z = (np.arange(nz) + 0.5) * 250.0
    p = 7.0e4 * np.exp(-z / 8000.0)
    t = 262.0 - 0.005 * z
    e_si = np.exp(9.550426 - 5723.265 / t + 3.53068 * np.log(t)
                  - 0.00728332 * t)
    qvsi = 0.622 * e_si / (p - e_si)
    cols = dict(t=t, qv=1.5 * qvsi, qc=np.where(z < 2000, 1e-4, 0.0),
                qi=np.where(z > 6000, 1e-6, 0.0), qr=np.zeros(nz),
                qs=np.where(z > 5000, 1e-5, 0.0),
                qg=np.where(z > 5000, 1e-6, 0.0),
                ni=np.where(z > 6000, 1e3, 0.0), nr=np.zeros(nz),
                nc=np.full(nz, 1e8), nwfa=np.full(nz, 3e8),
                nifa=np.full(nz, 1e6))

    def b(x, noise=0.2):
        arr = np.broadcast_to(x, (ncol, nz)) * (
            1.0 + noise * rng.random((ncol, 1)))
        return torch.tensor(arr, dtype=dtype, device=dev)

    st = ColumnState(**{k: b(v, 0.002 if k == "t" else 0.2)
                        for k, v in cols.items()})
    pres = b(p, 0.0)
    cfg = MicroConfig(iiwarm=False, is_aerosol_aware=True)
    tables = S.device_tables(get_tables(iiwarm=False), dtype, dev)
    tv = S._table_stage(*S._prologue(st, pres, cfg), tables, cfg, 10.0)
    p8 = A.fused_rates_ref(st, pres, tv, cfg, 10.0, True)
    w = seeded_w(ncol, nz, 4, dtype, dev)
    return ((st, pres, w, {k: p8[k] for k in S.P8_OUT}, tables, cfg, 10.0),
            torch.full_like(pres, 250.0), p8["pni_inu"])


def lookup_vs_plain(label, args, dzq, digests):
    """``lookup_stage`` against its plain version on one set of arguments:
    in float64 ``xnc_act`` within 1e-12 relative and ``wev`` exact, and
    ``fused_post``'s outputs from the kernel's lookups against those from
    the plain ones within 1e-12 normalised; in float32 the cells whose
    lookups moved by more than 1e-5 relative (an index that flipped at a
    knife edge: a wev bin or the temperature bin of the activation table)
    counted and bounded as ``equiv_report`` bounds its noise, at most 0.5%
    of the cells.  Records and prints the batch's digest."""
    import kid_tpu_torch.micro.split_step as A
    state, pres, w, p8, tables, cfg, dt_f = args
    got = A.lookup_stage(*args)
    want = A.lookup_stage_ref(*args)
    torch.cuda.synchronize()
    f64 = state.qv.dtype == torch.float64
    rel = {k: ((got[k].double() - want[k].double()).abs()
               / want[k].double().abs()) for k in A.AUX_KEYS}
    n = state.qv.numel()
    moved = int(((rel["xnc_act"] > 1e-5) | (rel["wev"] > 1e-5)).sum())
    worst_x = float(rel["xnc_act"].max())
    d = record_digest(digests, "lookup_stage", label, got)
    line = (f"lookup_stage vs plain  {label}: xnc_act worst relative "
            f"{worst_x:.3e}, wev {int((got['wev'] != want['wev']).sum())} "
            f"of {n} cells differ, {moved} cells moved by more than 1e-5")
    if f64:
        post_k = flat(A.fused_post(state, pres, dzq, p8, got, cfg, dt_f,
                                   False))
        post_p = flat(A.fused_post(state, pres, dzq, p8, want, cfg, dt_f,
                                   False))
        torch.cuda.synchronize()
        worst_post = equiv_report(post_k, post_p, 1e-12)
        n_same = sum(torch.equal(post_k[k], post_p[k]) for k in post_p)
        line += (f"; fused_post from the kernel's lookups: {n_same} of "
                 f"{len(post_p)} outputs bit for bit, worst normalised "
                 f"error {worst_post:.3e} (limit 1e-12)")
        if worst_x > 1e-12 or not torch.equal(got["wev"], want["wev"]):
            raise AssertionError(f"lookup_stage {label}: xnc_act "
                                 f"{worst_x:.3e}, wev differs")
    elif moved > max(3, 0.005 * n):
        raise AssertionError(f"lookup_stage {label}: {moved} cells moved")
    print(f"{line}, digest {d}", flush=True)


def phase_lookup_stage(dev, card, digests, launches, res):
    """``lookup_stage`` (the aerosol step's phase-14 lookups) against its
    plain version: on aerosol1d's steps ``LOOKUP_STEPS`` in float32 at
    MAIN_NX columns and float64 at 1024, and on the cold column in both;
    a digest of each batch and a combined one; in float32 at the widths
    ``LOOKUP_TIMED_NX``, on step 200's arguments, its ms/launch beside its
    byte bound and the plain version's ms.  Returns the kernels-line
    record of MAIN_NX columns, whose launches are ``launches``."""
    import kid_tpu_torch.micro.split_step as A
    from kid_tpu_torch.driver.cases import AEROSOL1D
    for dtype in (torch.float64, torch.float32):
        case = dataclasses.replace(AEROSOL1D, nx=LOOKUP_NCOL[dtype])
        for n_steps in LOOKUP_STEPS:
            args, dzq = lookup_step_inputs(case, dtype, dev, n_steps)
            lookup_vs_plain(f"aerosol1d step {n_steps} ({case.nx}, "
                            f"{case.nz}) {str(dtype)[6:]}", args, dzq,
                            digests)
        args, dzq, pni_inu = cold_lookup_inputs(dtype, dev)
        lookup_vs_plain(f"cold column ({BATCH_NCOL}, 40) {str(dtype)[6:]}, "
                        f"{int((pni_inu > 0).sum())} cells nucleating ice",
                        args, dzq, digests)
        if int((pni_inu > 0).sum()) == 0:
            raise AssertionError("cold column: no ice nucleation")
    print_digests(digests, "lookup_stage")
    records = []
    for ncol in LOOKUP_TIMED_NX:
        case = dataclasses.replace(AEROSOL1D, nx=ncol)
        args, _ = lookup_step_inputs(case, torch.float32, dev, 200)
        state, pres, w, p8, tables, cfg, dt_f = args
        chans = ([getattr(state, k) for k in A.LOOKUP_STATE] + [pres, w]
                 + [p8[k] for k in A.LOOKUP_P8])
        out = torch.empty((len(A.AUX_KEYS), *state.qv.shape),
                          dtype=state.qv.dtype, device=dev)
        # the tables, each read once
        tabs = tuple(getattr(tables, k) for k in A.LOOKUP_TABLES)

        def got_want(args=args):
            got = A.lookup_stage(*args)
            want = A.lookup_stage_ref(*args)
            torch.cuda.synchronize()
            return got, want

        records.append(kernel_record(
            "lookup_stage", card, (chans[0][None], *chans[1:], *tabs),
            lambda chans=chans, tables=tables, out=out, cfg=cfg, dt_f=dt_f:
            A.launch_lookup(chans, tables, out, cfg, dt_f),
            lambda args=args: A.lookup_stage_ref(*args),
            out.numel() * out.element_size(), launches, got_want, res,
            f"aerosol1d's step 200 ({ncol} columns)"))
    main, wide = records
    main["also"] = {"aerosol1d_65536": {k: wide[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}}
    return main


def guard_shares(card, *plain):
    """Where the guards of the aerosol kernels run on the main path's last
    inputs: each guard's mask as ``solver.guarded`` sees it in the plain
    versions ``plain``, as the share of cells in the mask and the share of
    warps (32 levels of a column, one warp of the kernel) with a lane in
    it, which the kernel cannot skip."""
    from kid_tpu_torch.micro import solver as S
    masks = {}

    def record(name, mask, value):
        masks.setdefault(name, torch.broadcast_to(mask, value.shape))
        return value

    kept = S.guarded
    S.guarded = record
    try:
        for fn in plain:
            fn()
    finally:
        S.guarded = kept
    rows = []
    for name, m in masks.items():
        ncol, nz = m.shape
        lanes = torch.nn.functional.pad(m.to(torch.uint8), (0, -nz % 32))
        warps = lanes.view(ncol, -1, 32).amax(-1)
        rows.append(f"{name} {float(m.float().mean()):.3f} of cells, "
                    f"{float(warps.float().mean()):.3f} of warps")
    print(f"guards on aerosol1d's last inputs: {'; '.join(rows)} [{card}]",
          flush=True)


def device_profile(run, n) -> tuple:
    """``torch.profiler`` over ``run()``, ``n`` steps: (rows, wall), rows
    (kernel name, self device ms per step, launches per step) of every
    device kernel it records, wall the host-clock ms per step of the same
    window, so that device time over it is the busy share of one window
    (the profiler's own host work is in it, so the share is a lower
    bound)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    return [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0], wall


def check_profiled_launches(label, rows, path_kernels):
    """Each kernel of ``path_kernels`` ran once a profiled step, as the
    profiler saw it on the card (a graph's replays included)."""
    for name in path_kernels:
        per_step = sum(r[2] for r in rows if f"{name}_kernel" in r[0])
        if per_step != 1.0:
            for key, ms, cnt in rows:       # what the profiler did record
                print(f"  {ms:8.4f} ms/step {cnt:6.1f}x  {key[:110]}",
                      flush=True)
            raise AssertionError(f"{label}: the profiler recorded "
                                 f"{per_step} {name} launches a step, "
                                 f"expected 1")


def profile_steps(dev, card, st, tables, case, istep0, step_ms,
                  path_kernels, n=5, names=()):
    """Where a main-path step's device time goes: ``torch.profiler`` over
    ``n`` steps, self device time by kernel, the number of kernels a step
    launches, the device's busy share of the profiled window and each
    hand-written kernel's share of the device time; fails unless each
    kernel of ``path_kernels`` ran once a step, and unless no torch
    gather runs (the table stage and the aerosol lookup stage gather
    inside their kernels).  ``names`` are the streams of the
    timed run, so that the profile replays its captured step (other
    streams would capture one inside the profile)."""
    from kid_tpu_torch.driver.loop import simulate
    rows, wall = device_profile(
        lambda: simulate(st, tables, case, n, names, istep0=istep0,
                         device=dev), n)
    total = sum(r[1] for r in rows)
    if total == 0.0:
        print("profile: the profiler recorded no device time (not "
              "measured)", flush=True)
        return
    check_profiled_launches(f"profile of {case.name}", rows, path_kernels)
    gathers = sum(r[2] for r in rows if "gather" in r[0])
    if gathers != 0:
        raise AssertionError(f"profile of {case.name}: {gathers} torch "
                             f"gathers a step")
    n_kernels = sum(r[2] for r in rows)
    shares = []
    for name in path_kernels:
        t = sum(r[1] for r in rows if f"{name}_kernel" in r[0])
        shares.append(f"{name} {t:.3f} ms/step ({t / total:.3f} of device "
                      f"time, once a step)")
    print(f"profile of {n} {case.name} steps: device time {total:.3f} "
          f"ms/step in {n_kernels:.0f} kernels/step, busy share "
          f"{total / wall:.3f} of the profiled window's {wall:.3f} ms/step "
          f"(unprofiled {step_ms:.3f} ms/step); {'; '.join(shares)}; "
          f"{gathers:.0f} torch gathers a step [{card}]", flush=True)
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {ms:8.4f} ms/step {cnt:6.1f}x  {key[:90]}", flush=True)


def seeded_state(case, dev, seed=0):
    """The case's initial sounding plus seeded hydrometeor layers."""
    from kid_tpu_torch.driver.loop import KidState, initial_state
    rng = np.random.default_rng(seed)
    st = initial_state(case, torch.float64, dev)._asdict()
    z = case.grid().z

    def layer(lo, hi, amp):
        prof = np.where((z > lo * case.ztop) & (z < hi * case.ztop), amp,
                        0.0)
        arr = prof[None, :] * (1.0 + 0.3 * rng.random((case.nx, 1)))
        return torch.tensor(arr, dtype=torch.float64, device=dev)

    st["qc"] = layer(0.1, 0.3, 5.0e-4)
    st["qr"] = layer(0.0, 0.25, 2.0e-4)
    st["nr"] = (st["qr"] > 0).to(torch.float64) * 1.0e5
    if not case.micro.iiwarm:
        st["qi"] = layer(0.5, 0.9, 3.0e-5)
        st["ni"] = (st["qi"] > 0).to(torch.float64) * 1.0e4
        st["qs"] = layer(0.4, 0.8, 1.0e-4)
        st["qg"] = layer(0.3, 0.6, 5.0e-5)
    return KidState(**st)


def phase_end_to_end(dev):
    import kid_tpu_torch.driver.advection as ADV
    import kid_tpu_torch.micro.fused_step as F
    import kid_tpu_torch.micro.split_step as A
    import kid_tpu_torch.micro.table_stage as TS
    from kid_tpu_torch.driver.cases import CASES
    from kid_tpu_torch.driver.loop import FUSED_DRIVER_ENV, KidState, simulate
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    # the 1-D cases widened; orographic2d (mixed phase, x-advection) at its
    # own width, which sets its circulation
    cases = [dataclasses.replace(CASES[name], nx=E2E_NX)
             for name in ("mixed1", "warm1_recon", "aerosol1d")]
    cases.append(CASES["orographic2d"])
    for case in cases:
        name = case.name
        tables = device_tables(get_tables(iiwarm=case.micro.iiwarm),
                               torch.float64, dev)
        st0 = seeded_state(case, dev)
        # the kernels of this case's path, and their plain versions
        swaps = [(ADV, "advect", ADV.advect_ref),
                 (TS, "table_stage", TS.table_stage_ref)]
        if case.micro.is_aerosol_aware:
            swaps += [(A, "fused_rates", A.fused_rates_ref),
                      (A, "lookup_stage", A.lookup_stage_ref),
                      (A, "fused_post", A.fused_post_ref)]
        else:
            swaps += [(F, "fused_step", F.fused_step_ref)]
        n0 = read_counts()
        k_st, k_out = simulate(st0, tables, case, 20, istep0=150, device=dev)
        n1 = read_counts()
        for _, k, _ in swaps:
            if n1[k] - n0[k] != 20:
                raise AssertionError(f"kernel path did not launch {k}")
        kept = [(mod, k, getattr(mod, k)) for mod, k, _ in swaps]
        for mod, k, ref in swaps:            # the plain path, on the card,
            setattr(mod, k, ref)             # through the eager loop
        try:
            p_st, p_out = simulate(st0, tables, case, 20, istep0=150,
                                   device=dev, graphs=False)
        finally:
            for mod, k, fn in kept:
                setattr(mod, k, fn)
        torch.cuda.synchronize()
        worst = equiv_report(k_st._asdict(), p_st._asdict(), 1e-8)
        for k in PPT:
            a = getattr(k_out, k).cpu().numpy()
            b = getattr(p_out, k).cpu().numpy()
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-20,
                                       err_msg=f"{name} {k}")
        print(f"end to end {name} ({case.nx} columns, 20 steps, f64): kernel "
              f"path vs plain path worst normalised error {worst:.3e} "
              f"(limit 1e-8), precip streams within rtol 1e-8, rain "
              f"{float(k_out.ppt_rain.sum()):.4e}", flush=True)
        if case.is_1d:
            continue
        # the fused driver switch leaves a 2-D case on the default path
        os.environ[FUSED_DRIVER_ENV] = "1"
        try:
            n0 = read_counts()
            f_st, f_out = simulate(st0, tables, case, 20, istep0=150,
                                   device=dev)
            n1 = read_counts()
        finally:
            del os.environ[FUSED_DRIVER_ENV]
        launched = {k: n1[k] - n0[k] for k in n1}
        if launched != path_counts(n1, 20, STEP):
            raise AssertionError(f"{name} with {FUSED_DRIVER_ENV}=1: "
                                 f"launches {launched}")
        for f in KidState._fields:
            if not torch.equal(getattr(f_st, f), getattr(k_st, f)):
                raise AssertionError(f"{name} with {FUSED_DRIVER_ENV}=1: "
                                     f"{f} differs")
        for k in PPT:
            if not torch.equal(getattr(f_out, k), getattr(k_out, k)):
                raise AssertionError(f"{name} with {FUSED_DRIVER_ENV}=1: "
                                     f"{k} differs")
        print(f"end to end {name} with {FUSED_DRIVER_ENV}=1: launches "
              f"{launched}, state and precip bit-identical to the default "
              f"kernel path", flush=True)


def phase_fused_driver_end_to_end(dev):
    import kid_tpu_torch.driver.advection as ADV
    import kid_tpu_torch.micro.fused_kid_step as FK
    import kid_tpu_torch.micro.table_stage as TS
    from kid_tpu_torch.driver.cases import CASES
    from kid_tpu_torch.driver.loop import FUSED_DRIVER_ENV, simulate
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    scheme = ("theta", "qv", "qc", "qr", "nr", "qi", "ni", "qs", "qg")
    for name in ("mixed1", "warm1_recon"):
        case = dataclasses.replace(CASES[name], nx=E2E_NX)
        tables = device_tables(get_tables(iiwarm=case.micro.iiwarm),
                               torch.float64, dev)
        st0 = seeded_state(case, dev)

        def run(graphs=True):
            return simulate(st0, tables, case, 20, istep0=150, device=dev,
                            graphs=graphs)

        d_st, d_out = run()                  # the default kernel path
        kernels = FK.fused_kid_step, TS.table_stage, ADV.advect
        os.environ[FUSED_DRIVER_ENV] = "1"
        try:
            n0 = read_counts()
            k_st, k_out = run()
            n1 = read_counts()
            FK.fused_kid_step = FK.fused_kid_step_ref  # the plain path
            TS.table_stage = TS.table_stage_ref
            ADV.advect = ADV.advect_ref
            p_st, p_out = run(graphs=False)
        finally:
            FK.fused_kid_step, TS.table_stage, ADV.advect = kernels
            del os.environ[FUSED_DRIVER_ENV]
        torch.cuda.synchronize()
        launched = {k: n1[k] - n0[k] for k in n1}
        if launched != path_counts(n1, 20, KID):
            raise AssertionError(f"fused driver {name}: launches {launched}")
        worst = equiv_report(k_st._asdict(), p_st._asdict(), 1e-8)
        worst_d = equiv_report({f: getattr(k_st, f) for f in scheme},
                               {f: getattr(d_st, f) for f in scheme}, 1e-8)
        for k in PPT:
            a = getattr(k_out, k).cpu().numpy()
            for other, label in ((p_out, "plain"), (d_out, "default")):
                np.testing.assert_allclose(
                    a, getattr(other, k).cpu().numpy(), rtol=1e-8,
                    atol=1e-20, err_msg=f"fused driver {name} {k} vs {label}")
        drift = []
        for f in ("nc", "nwfa", "nifa"):
            a, b = getattr(k_st, f), getattr(d_st, f)
            rel = float((a - b).abs().max() / b.abs().max())
            drift.append(f"{f} {rel:.3e}")
        print(f"end to end fused driver {name} ({case.nx} columns, 20 steps, "
              f"f64): kernel path vs plain path worst normalised error "
              f"{worst:.3e} (limit 1e-8); vs the default kernel path on the "
              f"nine scheme fields {worst_d:.3e} (limit 1e-8); precip within "
              f"rtol 1e-8 of both; not gated, max |fused - default| / max "
              f"|default|: {', '.join(drift)}", flush=True)


def check_finite_nonnegative(label, tensors: dict):
    for k, v in tensors.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{label}: non-finite {k}")
        if float(v.min()) < 0.0:
            raise AssertionError(f"{label}: negative {k}")


def phase_2d(dev, card):
    """cumulus2d and orographic2d at their own size for their full length
    in float32 through ``run_case``, then again through ``simulate`` in
    timed windows (bit for bit the same run); launch counts, outputs,
    profile, scores against the float64 anchors, and ``fused_step`` on the
    path's last input.  Returns {case: launches}."""
    import kid_tpu_torch.micro.fused_step as F
    from kid_tpu_torch.driver.cases import CUMULUS2D, OROGRAPHIC2D
    from kid_tpu_torch.driver.loop import (KidState, initial_state, run_case,
                                           simulate)
    from kid_tpu_torch.micro import cuda_build
    from kid_tpu_torch.micro.solver import device_tables, tv_keys
    from kid_tpu_torch.micro.state import ColumnState
    from kid_tpu_torch.tables.cache import get_tables
    from kid_tpu_torch.validation.scores import score_2d_f32

    dtype, names = torch.float32, KidState._fields
    launches = {}
    for case in (CUMULUS2D, OROGRAPHIC2D):
        n, cfg = case.n_steps, case.micro
        t0 = time.perf_counter()
        reset_counts()
        final, streams = run_case(case, dtype, profile_diags=names,
                                  device=dev)
        torch.cuda.synchronize()
        counts = read_counts()
        run_s = time.perf_counter() - t0
        if counts != path_counts(counts, n, STEP):
            raise AssertionError(f"{case.name}: launches {counts} in {n} "
                                 f"steps, expected {n} of {STEP} only")
        launches[case.name] = counts
        check_finite_nonnegative(case.name, {
            **final._asdict(), **{k: getattr(streams, k) for k in PPT},
            **streams.profiles})

        # the same run in windows through simulate
        tables = device_tables(get_tables(iiwarm=cfg.iiwarm), dtype, dev)
        st = initial_state(case, dtype, dev)
        window_ms, outs = [], []
        last, restore = recording([(F, "pack_inputs")])
        try:
            for w in range(n // N_WINDOW_2D):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                st, out = simulate(st, tables, case, N_WINDOW_2D, names,
                                   istep0=w * N_WINDOW_2D, device=dev)
                e1.record()
                torch.cuda.synchronize()
                window_ms.append(e0.elapsed_time(e1) / N_WINDOW_2D)
                outs.append(out)
                if w == 0:          # profiled below, inside the flow's rise
                    st_first = st
            inputs = kept_inputs(last)
        finally:
            restore()
        for f in names:
            if not torch.equal(getattr(st, f), getattr(final, f)):
                raise AssertionError(f"{case.name}: windowed run differs "
                                     f"from run_case in {f}")
        for k in PPT:
            if not torch.equal(torch.cat([getattr(o, k) for o in outs]),
                               getattr(streams, k)):
                raise AssertionError(f"{case.name}: windowed {k} differs")
        step_ms = float(np.median(window_ms))
        print(f"2-D {case.name} ({case.nx}, {case.nz}) f32, {n} steps: "
              f"run_case {run_s:.1f} s with {n} advect, {n} table_stage and "
              f"{n} fused_step launches and no other kernel; {len(window_ms)} "
              f"windows of "
              f"{N_WINDOW_2D} steps through simulate, bit for bit the same: "
              f"median {step_ms:.3f} ms/step ({case.nx * 1e3 / step_ms:.0f} "
              f"column-steps/s), best {min(window_ms):.3f} ms/step, windows "
              f"{' '.join(f'{m:.3f}' for m in window_ms)} ms/step [{card}]",
              flush=True)
        profile_steps(dev, card, st_first, tables, case, N_WINDOW_2D,
                      step_ms, STEP, names=names)

        # scores against the float64 driver's full-size finals
        grid = case.grid()
        anchor = np.load(ROOT / "validation_finals"
                         / f"{case.name}_2dfp64.npz")

        def host(t):
            return t.double().cpu().numpy()

        entry = score_2d_f32(
            case.name, grid.rho0, grid.dz,
            {f: host(v) for f, v in initial_state(
                case, dtype, dev)._asdict().items()},
            {f: host(getattr(final, f)) for f in names},
            {k[4:]: host(getattr(streams, k)) for k in PPT},
            {f: host(streams.profiles[f]).mean(0) for f in names}, anchor)
        print(worst_field_line(case, entry, {f: host(getattr(final, f))
                                            for f in names}, anchor, card),
              flush=True)
        print(f"2-D {case.name} f32 against the f64 anchor: cumulative "
              f"precip {entry['cum_ppt_rain_rel']:.3e} (budget 2e-2), final "
              f"water paths wvp {entry['final_wvp_rel']:.3e} lwp "
              f"{entry['final_lwp_rel']:.3e} iwp {entry['final_iwp_rel']:.3e} "
              f"(2.5e-2), time-mean profiles "
              f"{entry['tmean_prof_worst_rel']:.3e} (4e-2), closure "
              f"{entry['closure']:.3e} (1e-2), worst final field "
              f"{entry['worst_target_field_rel']:.3e} (not gated), rain "
              f"{float(streams.ppt_rain.double().sum()):.4e} kg/m^2 x cols",
              flush=True)
        if not entry["pass"]:
            raise AssertionError(f"{case.name}: over a budget {entry}")

        # the kernel and its plain version on the path's last input
        x = inputs["pack_inputs"]
        st_in = ColumnState(*x[:12])
        tv = dict(zip(tv_keys(cfg), x[14:]))
        ncol, nz = x.shape[1:]
        out_bytes = (12 * ncol * nz + 4 * ncol) * x.element_size()

        def plain(x=x, st_in=st_in, tv=tv, cfg=cfg):
            return F.fused_step_ref(st_in, x[12], x[13], tv, cfg, case.dt,
                                    False)

        def got_want(x=x, cfg=cfg, plain=plain):
            y, ppt = F.launch_packed(x, cfg, case.dt, False)
            ref = plain()
            torch.cuda.synchronize()
            return flat(F.unpack_outputs(y, ppt, False)), flat(ref)

        res = cuda_build.resources("fused_step", nz, dtype, cfg.iiwarm, False)
        kernel_record("fused_step", card, x,
                      lambda x=x, cfg=cfg: F.launch_packed(x, cfg, case.dt,
                                                           False),
                      plain, out_bytes, n, got_want, res,
                      f"{case.name}'s last input "
                      f"({'warm' if cfg.iiwarm else 'mixed'}, "
                      f"{res['regs']} regs, {res['blocks_per_sm']} blocks "
                      f"of {(nz + 31) // 32 * 32} threads/SM)")
    return launches


def worst_field_line(case, entry, final, anchor, card) -> str:
    """Which final field scores worst against the anchor (the largest
    |f32 - f64| over the anchor field's largest magnitude), among the
    target fields and among nc, nwfa and nifa, and at which column and
    level its largest difference lies (not gated: the reference's 2-D f32
    validation gates integrated quantities only)."""
    from kid_tpu_torch.validation.scores import TARGET_FIELDS
    z = case.grid().z
    parts = []
    for label, fields in (("target", TARGET_FIELDS),
                          ("extra", [f for f in entry["fields"]
                                     if f not in TARGET_FIELDS])):
        f = max(fields, key=lambda k: entry["fields"][k])
        want = np.asarray(anchor[f], np.float64)
        col, lev = np.unravel_index(np.abs(final[f] - want).argmax(),
                                    want.shape)
        parts.append(f"worst {label} field {f} {entry['fields'][f]:.3e} at "
                     f"column {col}, level {lev} (z {z[lev]:.0f} m): f32 "
                     f"{final[f][col, lev]:.4e}, f64 anchor "
                     f"{want[col, lev]:.4e}, anchor max "
                     f"{np.abs(want).max():.4e}")
    return f"2-D {case.name} f32 final fields: {'; '.join(parts)} [{card}]"


def wrf_tile(dev, dtype=torch.float32):
    """mixed1's sounding with phase 4's seeded hydrometeor layers as a
    WRF_TILE (i, k, j) tile: the arguments of ``mp_driver_3d`` up to the
    accumulators, and the seeded accumulators."""
    from kid_tpu_torch.driver.cases import MIXED1
    ni_, nk, nj = WRF_TILE
    case = dataclasses.replace(MIXED1, nx=ni_ * nj, nz=nk)
    grid = case.grid()
    st = seeded_state(case, dev)

    def ikj(cols):
        cols = torch.as_tensor(cols, dtype=dtype, device=dev).expand(
            ni_ * nj, nk)
        return torch.movedim(cols.reshape(ni_, nj, nk), -1, 1).contiguous()

    args = tuple(ikj(getattr(st, k)) for k in (
        "qv", "qc", "qr", "qi", "qs", "qg", "ni", "nr", "theta"))
    args += (ikj(grid.exner), ikj(grid.pres),
             ikj(seeded_w(ni_ * nj, nk, 0, dtype, dev)), ikj(grid.dz))
    rng = np.random.default_rng(3)
    acc = tuple(torch.tensor(rng.uniform(0.0, 2.0, (ni_, nj)), dtype=dtype,
                             device=dev) for _ in range(3))
    return args, case.dt, acc, case.micro


def same_outputs(label, got, want):
    """Raise unless two nested outputs (tensors, None, dicts, tuples) hold
    the same bits; returns the number of tensors compared."""
    if isinstance(want, torch.Tensor):
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: graphed and eager differ")
        return 1
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: outputs differ")
        return sum(same_outputs(f"{label} {k}", got[k], want[k])
                   for k in want)
    if isinstance(want, tuple):
        names = getattr(want, "_fields", range(len(want)))
        return sum(same_outputs(f"{label} {k}", a, b)
                   for k, a, b in zip(names, got, want))
    if got is not None or want is not None:
        raise AssertionError(f"{label}: outputs differ")
    return 0


def graphed_and_eager(label, call, reps=20):
    """``call(graphs)`` (one call of an entry point) graphed and eager in
    turn: the same bits and the same launches a call, each mode's ms a
    call (events around ``reps`` calls, after a first call that captures)
    and device ms a call (profiler, 5 calls).  Returns ({mode: launch
    counts of one call}, {mode: (ms, device ms, kernels a call)})."""
    out, counts, times = {}, {}, {}
    for mode, graphs in (("eager", False), ("graphed", True)):
        call(graphs)                    # the capture (graphed)
        torch.cuda.synchronize()
        reset_counts()
        out[mode] = call(graphs)
        torch.cuda.synchronize()
        counts[mode] = read_counts()
        ms = time_ms(lambda: call(graphs), reps)
        rows, _ = device_profile(lambda: [call(graphs) for _ in range(5)], 5)
        times[mode] = (ms, sum(r[1] for r in rows), sum(r[2] for r in rows))
    if counts["graphed"] != counts["eager"]:
        raise AssertionError(f"{label}: launches {counts}")
    n = same_outputs(label, out["graphed"], out["eager"])
    return counts, times, n, out["graphed"]


def times_line(times) -> str:
    return "; ".join(f"{mode} {ms:.3f} ms/call (events), device {dms:.3f} "
                     f"ms/call in {k:.0f} kernels" for mode, (ms, dms, k)
                     in times.items())


def phase_wrf(dev, card):
    """``mp_driver_3d`` on a WRF-shaped tile, graphed and eager in turn:
    the same bits in every field, accumulator and radius, one
    ``fused_step`` launch a call both ways, ms and device ms a call; the
    result against ``batched_microphysics`` on the same columns reshaped
    by hand, the accumulators, the vapor repair, the layout moves' share,
    then the moment diagnostics on its output.  Returns the launches of
    one call."""
    from kid_tpu_torch.diag.moments import refl_10cm
    from kid_tpu_torch.driver import wrf_adapter as W
    from kid_tpu_torch.micro import ColumnState, batched_microphysics
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    args, dt, acc, cfg = wrf_tile(dev)
    tables = device_tables(get_tables(iiwarm=cfg.iiwarm), torch.float32,
                           dev)

    def call(eff=False, graphs=True):
        return W.mp_driver_3d(*args, dt, *acc, tables, cfg,
                              want_eff_rad=eff, device=dev, graphs=graphs)

    for eff in (False, True):
        counts, times, n, (fields, precip, _) = graphed_and_eager(
            "mp_driver_3d", lambda graphs, eff=eff: call(eff, graphs))
        if counts["graphed"] != path_counts(counts["graphed"], 1, CALL):
            raise AssertionError(f"mp_driver_3d: launches {counts}")
        print(f"mp_driver_3d{' with radii' if eff else ''} graphed and "
              f"eager on a {WRF_TILE} f32 tile: the same bits in {n} "
              f"outputs, 1 table_stage and 1 fused_step launch a call both "
              f"ways; "
              f"{times_line(times)}; wall "
              f"{times['eager'][0] / times['graphed'][0]:.2f}x [{card}]",
              flush=True)

    # by hand: (i, k, j) -> (i*j, k) columns, the column solver, back
    qv, qc, qr, qi, qs, qg, ni, nr, th, pii, p, w, dz = args
    ni_, nk, nj = qv.shape

    def cols(a):
        return a.permute(0, 2, 1).reshape(ni_ * nj, nk)

    def back(a):
        return a.reshape(ni_, nj, nk).permute(0, 2, 1)

    t = cols(th) * cols(pii)
    rho = 0.622 * cols(p) / (287.04 * t * (cols(qv) + 0.622))
    state = ColumnState(t=t, qv=cols(qv), qc=cols(qc), qi=cols(qi),
                        qr=cols(qr), qs=cols(qs), qg=cols(qg), ni=cols(ni),
                        nr=cols(nr), nc=cfg.nt_c / rho, nwfa=11.1e6 / rho,
                        nifa=0.5e6 * 0.01 / rho)
    out, ppt, _ = batched_microphysics(state, cols(p), cols(w), cols(dz), dt,
                                       tables, cfg, want_rates=False,
                                       device=dev)
    torch.cuda.synchronize()
    for k in ("qc", "qr", "qi", "qs", "qg", "ni", "nr"):
        if not torch.equal(fields[k], back(getattr(out, k))):
            raise AssertionError(f"mp_driver_3d: {k} differs from the "
                                 f"columns run by hand")
    if not torch.equal(fields["th"], back(out.t) / pii):
        raise AssertionError("mp_driver_3d: th differs")
    neg = back(out.qv) < 0.0
    if not (torch.equal(fields["qv"][~neg], back(out.qv)[~neg])
            and bool((fields["qv"][neg] >= 1.0e-7).all())):
        raise AssertionError("mp_driver_3d: qv repair")
    p_ra, p_sn, p_gr, p_ic = (a.reshape(ni_, nj) for a in ppt)
    rainncv = p_ra + p_sn + p_gr + p_ic
    for got, want in ((precip.rainncv, rainncv),
                      (precip.rainnc, acc[0] + rainncv),
                      (precip.snownc, acc[1] + p_sn + p_ic),
                      (precip.graupelnc, acc[2] + p_gr)):
        if not torch.equal(got, want):
            raise AssertionError("mp_driver_3d: accumulators")
    sr = precip.sr
    if not (torch.isfinite(sr).all() and float(sr.min()) >= 0.0
            and float(sr.max()) <= 1.0 + 1e-6):
        raise AssertionError("mp_driver_3d: snow ratio out of [0, 1]")
    check_finite_nonnegative("mp_driver_3d", fields)

    # ms per call, and the two layout moves (in, out) alone
    ms = time_ms(call, 20)
    ins = args
    outs = [back(getattr(out, k)) for k in
            ("qv", "qc", "qr", "qi", "qs", "qg", "ni", "nr", "t")]
    in_ms = time_ms(lambda: [W._ikj_to_cols(a) for a in ins], 20)
    out_ms = time_ms(lambda: [W._cols_to_ikj(cols(a), ni_, nj)
                              for a in outs], 20)
    print(f"mp_driver_3d on an (i, k, j) = {tuple(qv.shape)} f32 tile "
          f"(mixed phase, {ni_ * nj} columns), graphed: {ms:.3f} ms/call, 1 "
          f"table_stage and 1 fused_step launch a call; layout moves "
          f"(i,k,j) -> columns {in_ms:.3f} ms, columns -> (i,k,j) "
          f"{out_ms:.3f} ms, "
          f"{(in_ms + out_ms) / ms:.3f} of the call; equal to the columns "
          f"run by hand; rain {float(precip.rainncv.double().sum()):.4e}, "
          f"snow ratio max {float(sr.max()):.3f} [{card}]", flush=True)

    # the moment diagnostics on its output
    fields, _, eff = call(eff=True)
    windows = {"re_cloud": (2.49e-6, 50.0e-6), "re_ice": (4.99e-6, 125.0e-6),
               "re_snow": (9.99e-6, 999.0e-6)}
    for k, (lo, hi) in windows.items():
        v = eff[k]
        lo, hi = torch.tensor([lo, hi], dtype=v.dtype).tolist()
        if not (torch.isfinite(v).all() and float(v.min()) >= lo
                and float(v.max()) <= hi):
            raise AssertionError(f"mp_driver_3d: {k} outside [{lo}, {hi}]")
    f = {k: cols(v) for k, v in fields.items()}
    dbz = refl_10cm(f["qv"], f["qc"], f["qr"], f["nr"], f["qs"], f["qg"],
                    f["th"] * cols(pii), cols(p))
    if not (torch.isfinite(dbz).all() and float(dbz.min()) > -40.0
            and float(dbz.max()) < 80.0):
        raise AssertionError("refl_10cm outside (-40, 80) dBZ")
    print("mp_driver_3d diagnostics: "
          + ", ".join(f"{k} {float(eff[k].min()) * 1e6:.2f}-"
                      f"{float(eff[k].max()) * 1e6:.2f} um"
                      for k in windows)
          + f"; refl_10cm {float(dbz.min()):.1f} to {float(dbz.max()):.1f} "
          f"dBZ, {float((dbz > 0).double().mean()):.3f} of cells above 0",
          flush=True)
    release_graphs()
    return counts["graphed"]


def phase_batched(dev, card):
    """``batched_microphysics`` on a seeded (MAIN_NX, 120) f32 batch,
    ``pres`` broadcast from one row as the bench passes it, graphed and
    eager in turn for each cell of BATCHED_CELLS: the same bits and the
    same launches, ms and device ms a call.  Returns {path: launches of
    one graphed call}."""
    from kid_tpu_torch.config import MicroConfig
    from kid_tpu_torch.micro import batched_microphysics
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    dtype = torch.float32
    st, pres, dzq = make_batch(MAIN_NX, 120, 5, dtype, dev)
    pres = pres[:1].expand_as(pres)
    w = seeded_w(MAIN_NX, 120, 5, dtype, dev)
    tables = device_tables(get_tables(iiwarm=False), dtype, dev)
    paths = {}
    for label, (aerosol, rates, kernels) in BATCHED_CELLS.items():
        cfg = MicroConfig(iiwarm=False, is_aerosol_aware=aerosol)

        def call(graphs):
            return batched_microphysics(st, pres, w, dzq, 10.0, tables, cfg,
                                        want_rates=rates, device=dev,
                                        graphs=graphs)

        counts, times, n, out = graphed_and_eager(
            f"batched_microphysics {label}", call)
        if counts["graphed"] != {k: int(k in kernels)
                                 for k in counts["graphed"]}:
            raise AssertionError(f"batched {label}: launches {counts}")
        check_finite_nonnegative(f"batched {label}", out[0]._asdict())
        print(f"batched_microphysics {label} ({MAIN_NX}, 120) f32 graphed "
              f"and eager: the same bits in {n} outputs, launches a call "
              f"{ {k: v for k, v in counts['graphed'].items() if v} } both "
              f"ways; {times_line(times)}; column-steps/s graphed "
              f"{MAIN_NX * 1e3 / times['graphed'][0]:.0f}, eager "
              f"{MAIN_NX * 1e3 / times['eager'][0]:.0f} [{card}]",
              flush=True)
        paths[f"batched_graphed_{label.replace(', ', '_')}"] = \
            counts["graphed"]
    release_graphs()
    return paths


def release_graphs():
    """Drop the captured entry-point calls and their memory, so that a
    later phase's peak device memory does not hold them."""
    from kid_tpu_torch.micro import graphs
    graphs.GRAPHS.clear()
    torch.cuda.empty_cache()


def check_ranks(label, ranks, n, graphed):
    """Raise unless every rank made one halo exchange and one
    ``table_stage`` and one ``fused_step`` launch (and no other) a step,
    and replayed a captured step if ``graphed`` (else ran eagerly)."""
    for r in ranks:
        if r["launches"] != path_counts(r["launches"], n, STEP):
            raise AssertionError(f"{label} rank {r['rank']}: launches "
                                 f"{r['launches']}, expected {n} of {STEP}")
        if r["exchange_calls"] != n:
            raise AssertionError(f"{label} rank {r['rank']}: "
                                 f"{r['exchange_calls']} halo exchanges in "
                                 f"{n} steps")
        if (r["capture_ms"] is not None) != graphed:
            raise AssertionError(f"{label} rank {r['rank']}: capture_ms "
                                 f"{r['capture_ms']}, graphed {graphed}")


def rank_line(ranks) -> str:
    """Each rank's ms/step (host clock, its own window; the ranks share
    the card), exchange share, capture ms and peak device memory."""
    return "; ".join(
        f"rank {r['rank']} {r['ms_per_step']:.3f} ms/step, exchange "
        f"{r['exchange_share']:.3f} of it, capture "
        + ("none" if r["capture_ms"] is None else f"{r['capture_ms']:.1f} ms")
        + f", peak {r['peak_bytes'] / 2**30:.2f} GiB" for r in ranks)


def phase_sharded_2d(dev, card):
    """cumulus2d at its own 64 x 60 for all 900 steps in float32 in one
    process and on N_RANKS ranks on this card (gloo, halo slabs staged
    through the host, each rank graphed): the same bits, and the sharded
    run scored as the reference's ``cumulus2d_sharded`` row.  Returns the
    ranks' summed launches."""
    from kid_tpu_torch.driver.cases import CUMULUS2D
    from kid_tpu_torch.validation import twod
    case = CUMULUS2D
    t0 = time.perf_counter()
    one = twod.run_2d(case, torch.float32, dev)
    t1 = time.perf_counter()
    many = twod.run_2d_sharded(case, N_RANKS, torch.float32, dev)
    t2 = time.perf_counter()
    n = case.n_steps
    if one["launches"] != path_counts(one["launches"], n, STEP):
        raise AssertionError(f"cumulus2d: launches {one['launches']}")
    check_ranks("cumulus2d", many["ranks"], n, True)
    if not twod.same_bits(one, many):
        diffs = {f: float(np.abs(one["final"][f] - many["final"][f]).max())
                 for f in one["final"]}
        raise AssertionError(f"cumulus2d on {N_RANKS} ranks differs from "
                             f"one process: {diffs}")
    entry = twod.score(case, many)
    ranks = many["ranks"]
    print(f"sharded cumulus2d ({case.nx}, {case.nz}) f32, {n} steps on "
          f"{N_RANKS} ranks ({', '.join(r['device'] for r in ranks)}, gloo, "
          f"host-staged halos, graphed): bit for bit the single-process run "
          f"(finals and the four precip series); one process "
          f"{t1 - t0:.1f} s, {N_RANKS} ranks {t2 - t1:.1f} s with spawning; "
          f"{rank_line(ranks)} (each rank's window holds its capture); "
          f"{many['launches']['table_stage']} table_stage and "
          f"{many['launches']['fused_step']} fused_step launches in all "
          f"[{card}]", flush=True)
    print("  " + twod.line("cumulus2d_sharded", entry), flush=True)
    if not entry["pass"]:
        raise AssertionError(f"cumulus2d_sharded over a budget: {entry}")
    return many["launches"]


def phase_flagship(dev, card):
    """The flagship: cumulus2d widened to FLAGSHIP_NX columns at its 60
    levels in float32, FLAGSHIP_SPIN spin-up steps, then FLAGSHIP_STEPS
    steps timed in one process (after the same window once untimed) and
    profiled, ``fused_step`` on the path's last input, and the same steps
    on N_RANKS ranks of this card (graphed) from the spun-up state: the
    same bits.  Returns the timed window's launches."""
    import kid_tpu_torch.micro.fused_step as F
    from kid_tpu_torch.dist import launch
    from kid_tpu_torch.driver.cases import CUMULUS2D
    from kid_tpu_torch.driver.loop import (build_flow, initial_state,
                                           simulate)
    from kid_tpu_torch.micro import cuda_build
    from kid_tpu_torch.micro.solver import device_tables, tv_keys
    from kid_tpu_torch.micro.state import ColumnState
    from kid_tpu_torch.tables.cache import get_tables
    case = dataclasses.replace(CUMULUS2D, nx=FLAGSHIP_NX,
                               cell_nx=CUMULUS2D.nx)
    dtype, n, i0 = torch.float32, FLAGSHIP_STEPS, FLAGSHIP_SPIN
    torch.cuda.reset_peak_memory_stats(dev)
    tables = device_tables(get_tables(iiwarm=True), dtype, dev)
    last, restore = recording([(F, "pack_inputs")])
    try:
        first_ms, st = first_graphed_call(simulate, dev, initial_state(
            case, dtype, dev), tables, case)
        t0 = time.perf_counter()
        st, _ = simulate(st, tables, case, i0 - 1, istep0=1, device=dev)
        simulate(st, tables, case, n, istep0=i0, device=dev)
        torch.cuda.synchronize()
        spin_s = time.perf_counter() - t0
        reset_counts()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        final, out = simulate(st, tables, case, n, istep0=i0, device=dev)
        e1.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        counts = read_counts()
        inputs = kept_inputs(last)
    finally:
        restore()
    step_ms = e0.elapsed_time(e1) / n
    peak = torch.cuda.max_memory_allocated(dev)
    # what a call of simulate costs before its first step: the flow
    # patterns built on the host and copied, as every call built them
    # before they were kept (``build_flow``), and a 0-step call now (the
    # flow and the captured step kept in ``BLOCKS``)
    t0 = time.perf_counter()
    build_flow(case, dtype, st.qv.device)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    simulate(st, tables, case, 0, istep0=i0, device=dev)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    if counts != path_counts(counts, n, STEP):
        raise AssertionError(f"flagship: launches {counts} in {n} steps")
    check_finite_nonnegative("flagship", {
        **final._asdict(), **{k: getattr(out, k) for k in PPT}})
    print(f"flagship cumulus2d ({case.nx}, {case.nz}) f32: spin-up of "
          f"{i0} steps after the first, and the window once untimed, in "
          f"{spin_s:.1f} s; {n} steps "
          f"from step {i0}: {step_ms:.3f} ms/step (events; host clock "
          f"{wall_ms:.3f}), {case.nx * 1e3 / step_ms:.0f} column-steps/s, "
          f"of which simulate's set-up (a 0-step call) {setup_ms:.1f} ms, "
          f"{setup_ms / n:.3f} ms/step (the flow built for each call, as "
          f"before it was kept: {build_ms:.1f} ms, {build_ms / n:.3f} "
          f"ms/step); the spin-up's first call (warm-up, capture and 1 "
          f"step) {first_ms:.1f} ms; "
          f"{counts['advect']} advect, {counts['table_stage']} table_stage "
          f"and {counts['fused_step']} fused_step launches and no other "
          f"kernel; peak device memory "
          f"{peak / 2**30:.2f} GiB; qc max "
          f"{float(final.qc.max()):.3e}, rain in the window "
          f"{float(out.ppt_rain.double().sum()):.4e} [{card}]", flush=True)
    profile_steps(dev, card, final, tables, case, i0 + n, step_ms, STEP)

    # fused_step and its plain version on the path's last input
    x = inputs["pack_inputs"]
    cfg = case.micro
    st_in = ColumnState(*x[:12])
    tv = dict(zip(tv_keys(cfg), x[14:]))
    ncol, nz = x.shape[1:]
    res = cuda_build.resources("fused_step", nz, dtype, True, False)

    def plain():
        return F.fused_step_ref(st_in, x[12], x[13], tv, cfg, case.dt, False)

    def got_want():
        y, ppt = F.launch_packed(x, cfg, case.dt, False)
        ref = plain()
        torch.cuda.synchronize()
        return flat(F.unpack_outputs(y, ppt, False)), flat(ref)

    kernel_record("fused_step", card, x,
                  lambda: F.launch_packed(x, cfg, case.dt, False), plain,
                  (12 * ncol * nz + 4 * ncol) * x.element_size(), n,
                  got_want, res, f"the flagship's last input (warm, "
                  f"{res['regs']} regs, {res['blocks_per_sm']} blocks of "
                  f"{(nz + 31) // 32 * 32} threads/SM)")
    del inputs, x, st_in, tv

    # the same window on the ranks, from the spun-up state
    t0 = time.perf_counter()
    sharded = launch.run_sharded(case, N_RANKS, n, dtype,
                                 *launch.default_layout(N_RANKS, dev),
                                 istep0=i0, state0=st, warmup_steps=n)
    ranks_s = time.perf_counter() - t0
    diffs = {f: float(np.abs(getattr(final, f).cpu().numpy()
                             - sharded.fields[f]).max())
             for f in final._fields
             if not np.array_equal(getattr(final, f).cpu().numpy(),
                                   sharded.fields[f])}
    diffs.update({k: 1.0 for k in PPT if not np.array_equal(
        getattr(out, k).cpu().numpy(), sharded.ppt[k])})
    if diffs:
        raise AssertionError(f"flagship on {N_RANKS} ranks differs from one "
                             f"process: {diffs}")
    check_ranks("flagship", sharded.ranks, n, True)
    print(f"flagship on {N_RANKS} ranks "
          f"({', '.join(r['device'] for r in sharded.ranks)}, gloo, "
          f"host-staged halos, graphed), the same {n} steps from the "
          f"spun-up state: bit for bit the single-process run (finals and "
          f"the four precip series); {ranks_s:.1f} s with spawning and {n} "
          f"warm-up steps (the capture among them); "
          f"{rank_line(sharded.ranks)} [{card}]", flush=True)
    return counts


def phase_one_rank_in_step(dev, card):
    """cumulus2d at its own 64 x 60 for all 900 steps in float32 on one
    rank of ``simulate_sharded`` (``dist.launch``, gloo on this card),
    graphed, its capture in 20 warm-up steps: the step holds the halo
    exchange (the edge columns packed into the ghost buffers, one rank's
    periodic wrap), so one replay is one whole step.  The same bits as
    ``simulate``, one exchange and one ``fused_step`` counted a replay,
    and, in ``N_PROFILED`` profiled steps more, no host call of the
    exchange; the rank's ms/step beside ``simulate``'s (host clock, each
    after a call that captured its step).  Returns the rank's
    launches."""
    from kid_tpu_torch.dist import launch
    from kid_tpu_torch.driver.cases import CUMULUS2D
    from kid_tpu_torch.driver.loop import KidState, initial_state, simulate
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    case, dtype, n = CUMULUS2D, torch.float32, CUMULUS2D.n_steps
    tables = device_tables(get_tables(iiwarm=True), dtype, dev)
    st0 = initial_state(case, dtype, dev)
    simulate(st0, tables, case, 1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, out = simulate(st0, tables, case, n, device=dev)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    run = launch.run_sharded(case, 1, n, dtype, [str(dev)], "gloo",
                             warmup_steps=20, profile_steps=N_PROFILED)
    run_s = time.perf_counter() - t0
    diffs = [f for f in KidState._fields if not np.array_equal(
        getattr(final, f).cpu().numpy(), run.fields[f])]
    diffs += [k for k in PPT if not np.array_equal(
        getattr(out, k).cpu().numpy(), run.ppt[k])]
    if diffs:
        raise AssertionError(f"cumulus2d on one rank, the exchange in the "
                             f"step, differs from simulate in {diffs}")
    check_ranks("cumulus2d on one rank", run.ranks, n, True)
    (r,) = run.ranks
    prof = r["profile"]
    if r["placement"] != "step" or prof["host_exchange_calls"] != 0.0:
        raise AssertionError(f"cumulus2d on one rank: exchange "
                             f"{r['placement']}, {prof} in the replays")
    print(f"one rank of simulate_sharded, cumulus2d ({case.nx}, {case.nz}) "
          f"f32, {n} steps ({r['device']}, gloo, graphed, the exchange in "
          f"the step): bit for bit simulate's run (finals and the four "
          f"precip series), {r['exchange_calls']} exchanges, "
          f"{r['launches']['table_stage']} table_stage and "
          f"{r['launches']['fused_step']} fused_step launches counted, "
          f"{prof['host_exchange_calls']:.0f} host calls of the exchange a "
          f"profiled step; {r['ms_per_step']:.3f} ms/step (host clock; "
          f"simulate {one_ms:.3f}), device {prof['device_ms']:.3f} ms/step "
          f"(profiler, {N_PROFILED} steps), capture {r['capture_ms']:.1f} "
          f"ms, peak {r['peak_bytes'] / 2**30:.2f} GiB; {run_s:.1f} s with "
          f"spawning [{card}]", flush=True)
    return r["launches"]


def phase_cli(dev, card):
    """``python -m kid_tpu_torch run mixed1`` on this card for
    ``CLI_STEPS`` steps with ``--out`` (classic NetCDF) and
    ``--checkpoint-dir``, then ``--resume`` to twice as many: the first
    run's NetCDF file is the one ``registry_from_run`` writes from
    ``simulate``'s streams over the same steps, byte for byte, and the
    resumed run's checkpointed state is ``simulate``'s over
    ``2 * CLI_STEPS`` steps in one call, bit for bit; both runs' wall
    seconds (a process each: the import, the tables from their cache, the
    kernel libraries loaded, the capture)."""
    from kid_tpu_torch.diag.registry import registry_from_run
    from kid_tpu_torch.driver.cases import MIXED1
    from kid_tpu_torch.driver.loop import (ALL_PROFILE_NAMES,
                                           FUSED_DRIVER_ENV, KidState,
                                           initial_state, simulate)
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    from kid_tpu_torch.utils.checkpoint import RunCheckpointer
    case, dtype, n = MIXED1, torch.float32, CLI_STEPS
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    env.pop(FUSED_DRIVER_ENV, None)
    with tempfile.TemporaryDirectory(prefix="kid_cli_") as tmp:
        got_nc, want_nc = Path(tmp) / "cli.nc", Path(tmp) / "simulate.nc"
        ck = Path(tmp) / "ck"
        walls, said = [], []
        for args in (("--steps", str(n), "--out", str(got_nc)),
                     ("--steps", str(2 * n), "--resume")):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "kid_tpu_torch", "run", case.name,
                 "--checkpoint-dir", str(ck), *args], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=600)
            walls.append(time.perf_counter() - t0)
            if proc.returncode:
                raise AssertionError(f"CLI {args}: exit {proc.returncode}: "
                                     f"{proc.stdout[-1000:]}"
                                     f"{proc.stderr[-2000:]}")
            said.append(" ".join(line.strip() for line in
                                 proc.stdout.splitlines()
                                 if "done in" in line or "resumed" in line))
        tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype,
                               dev)
        st0 = initial_state(case, dtype, dev)
        _, streams = simulate(st0, tables, case, n, ALL_PROFILE_NAMES,
                              device=dev)
        reg = registry_from_run(case.name, streams, case.nx)
        reg.to_netcdf(str(want_nc))
        got, want = got_nc.read_bytes(), want_nc.read_bytes()
        if got != want:
            first = next((i for i, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
            raise AssertionError(f"CLI NetCDF ({len(got)} bytes) differs "
                                 f"from simulate's ({len(want)} bytes) from "
                                 f"byte {first}")
        final, _ = simulate(st0, tables, case, 2 * n, ALL_PROFILE_NAMES,
                            device=dev)
        step, saved = RunCheckpointer(str(ck), case.name).restore(device=dev)
    bad = [f for f in KidState._fields
           if not torch.equal(getattr(saved, f), getattr(final, f))]
    if step != 2 * n or bad:
        raise AssertionError(f"CLI resumed to step {step}: differs from "
                             f"simulate over {2 * n} steps in {bad}")
    print(f"CLI: python -m kid_tpu_torch run {case.name} (nx {case.nx}, nz "
          f"{case.nz}, f32, every stream) --steps {n} --out .nc "
          f"--checkpoint-dir: {walls[0]:.1f} s wall, its NetCDF file "
          f"({len(got)} bytes, {len(reg.names())} streams) byte for byte "
          f"the one simulate's streams give; --steps {2 * n} --resume: "
          f"{walls[1]:.1f} s wall, its state at step {step} bit for bit "
          f"simulate's over {2 * n} steps in one call; the CLI said: "
          f"{' | '.join(said)} [{card}]", flush=True)


def phase_validation(dev, card):
    """The five 1-D cases at full length in float32, scored against the
    oracle's float64 finals with the reference's fixed f32 budgets, the
    chaos member for CHAOS_CASES.  Returns {case: launches}."""
    from kid_tpu_torch.validation import cases as V
    launches, failed = {}, []
    for name in V.RUNS:
        e = V.validate_case(name, torch.float32, dev,
                            chaos=name in CHAOS_CASES)
        launches[name] = e["launches"]
        print(V.summary_line(name, e)
              + f"; launches {e['launches']} [{card}]", flush=True)
        want = SPLIT if name == "aerosol1d" else STEP
        if e["launches"] != path_counts(e["launches"], e["n_steps"], want):
            raise AssertionError(f"{name}: launches {e['launches']}")
        if not e["pass"]:
            failed.append(name)
    if failed:
        raise AssertionError(f"over an f32 budget: {failed}")
    return launches


def to_host(result):
    """A (KidState, StepOutputs) with every tensor on the host."""
    st, out = result
    return (type(st)(*[t.cpu() for t in st]), out._replace(
        **{k: getattr(out, k).cpu() for k in PPT},
        profiles={k: v.cpu() for k, v in out.profiles.items()}))


def same_bits(label, got, want):
    """Raise unless two (KidState, StepOutputs) hold the same bits."""
    (g_st, g_out), (w_st, w_out) = got, want
    pairs = [(f, getattr(g_st, f), getattr(w_st, f)) for f in g_st._fields]
    pairs += [(k, getattr(g_out, k), getattr(w_out, k)) for k in PPT]
    if set(g_out.profiles) != set(w_out.profiles):
        raise AssertionError(f"{label}: streams differ")
    pairs += [(k, v, w_out.profiles[k]) for k, v in g_out.profiles.items()]
    for k, a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: graphed and eager differ in {k}")
    return len(pairs) - len(g_st._fields)


def phase_graphs_vs_eager(dev, card):
    """Each cell of GRAPH_CELLS through the graphed loop (the default) and
    the eager loop in this call, the eager first: the same bits in the
    final state and every stream, the same launches; wall ms/step (host
    clock, and events), device ms/step and kernels per step (profiler,
    ``N_PROFILED`` steps, each path kernel once a step), busy share (of
    the profiled window), peak device memory, and the first graphed
    call (warm-up, capture and one step).  The 1-D cells and the flagship
    are timed without profile streams, as their main paths run, and
    checked once more with streams; the 2-D cells run all streams."""
    from kid_tpu_torch.driver.cases import (AEROSOL1D, CUMULUS2D, MIXED1,
                                            OROGRAPHIC2D)
    from kid_tpu_torch.driver.loop import (BLOCKS, FUSED_DRIVER_ENV,
                                           KidState, initial_state,
                                           simulate)
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    wide = {"mixed1": dataclasses.replace(MIXED1, nx=MAIN_NX),
            "aerosol1d": dataclasses.replace(AEROSOL1D, nx=MAIN_NX),
            "fused driver": dataclasses.replace(MIXED1, nx=MAIN_NX),
            "cumulus2d": CUMULUS2D, "orographic2d": OROGRAPHIC2D,
            "flagship": dataclasses.replace(CUMULUS2D, nx=FLAGSHIP_NX,
                                            cell_nx=CUMULUS2D.nx)}
    row_kernels = {label: STEP for label in wide}
    row_kernels["aerosol1d"] = SPLIT
    row_kernels["fused driver"] = KID
    dtype = torch.float32
    rows = {}
    for label, (n, i0, timed_names, check_names) in GRAPH_CELLS.items():
        case = wide[label]
        BLOCKS.clear()
        torch.cuda.empty_cache()
        if label == "fused driver":
            os.environ[FUSED_DRIVER_ENV] = "1"
        try:
            tables = device_tables(get_tables(iiwarm=case.micro.iiwarm),
                                   dtype, dev)
            st0 = (KidState(*[t.to(dtype) for t in seeded_state(case, dev)])
                   if i0 else initial_state(case, dtype, dev))

            def run(graphs, names=timed_names, steps=n):
                return simulate(st0, tables, case, steps, names, istep0=i0,
                                device=dev, graphs=graphs)

            got, row, profiles = {}, {}, {}
            # each mode's result goes to the host, so that the other's
            # peak device memory does not hold it
            for mode, graphs in (("eager", False), ("graphed", True)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                if graphs:              # the capture, in a 1-step call
                    t0 = time.perf_counter()
                    run(True, steps=1)
                    torch.cuda.synchronize()
                    row["first_call_ms"] = (time.perf_counter() - t0) * 1e3
                reset_counts()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                result = run(graphs)
                e1.record()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / n
                peak = torch.cuda.max_memory_allocated(dev)
                got[mode] = to_host(result)
                del result
                counts = read_counts()
                prof, prof_wall = device_profile(
                    lambda: run(graphs, steps=N_PROFILED), N_PROFILED)
                if label in TWO_WINDOWS and not graphs:
                    two_windows(f"{label} {mode}", prof,
                                lambda: run(graphs, steps=N_PROFILED), card)
                check_profiled_launches(f"{label} {mode}", prof,
                                        row_kernels[label])
                profiles[mode] = prof
                device_ms = sum(r[1] for r in prof)
                row[mode] = dict(
                    wall_ms=wall, event_ms=e0.elapsed_time(e1) / n,
                    device_ms=device_ms,
                    kernels=sum(r[2] for r in prof),
                    busy=device_ms / prof_wall,
                    peak_gib=peak / 2**30,
                    launches={k: v for k, v in counts.items() if v})
            if row["graphed"]["launches"] != row["eager"]["launches"]:
                raise AssertionError(f"{label}: launches {row}")
            n_streams = same_bits(label, got["graphed"], got["eager"])
            final, out = got.pop("graphed")
            check_finite_nonnegative(label, {
                **final._asdict(), **{k: getattr(out, k) for k in PPT}})
            del got, final, out
            if check_names is not None:
                n_streams = same_bits(label,
                                      to_host(run(True, check_names)),
                                      to_host(run(False, check_names)))
        finally:
            os.environ.pop(FUSED_DRIVER_ENV, None)
        e, g = row["eager"], row["graphed"]
        print(f"graphs vs eager {label} ({case.nx}, {case.nz}) f32, {n} "
              f"steps from step {i0}: the same bits in the final state and "
              f"{n_streams} streams, launches {g['launches']}; "
              + "; ".join(
                  f"{mode} wall {r['wall_ms']:.3f} ms/step (events "
                  f"{r['event_ms']:.3f}), device {r['device_ms']:.3f} "
                  f"ms/step in {r['kernels']:.0f} kernels/step, busy "
                  f"{r['busy']:.3f}, peak {r['peak_gib']:.2f} GiB"
                  for mode, r in (("eager", e), ("graphed", g)))
              + f"; the first graphed call (warm-up, capture and 1 step) "
              f"{row['first_call_ms']:.1f} ms; wall "
              f"{e['wall_ms'] / g['wall_ms']:.2f}x [{card}]", flush=True)
        if label in KERNEL_DIFF_CELLS:
            kernel_diff(label, profiles["eager"], profiles["graphed"], card)
        rows[label] = row
    BLOCKS.clear()
    for label in GRAPH_RANK_CELLS:
        rows[f"{label} on {N_RANKS} ranks"] = ranks_graphs_vs_eager(
            dev, card, label, wide[label])
    return rows


def kernel_diff(label, eager, graphed, card):
    """The kernels of two profiled windows of a cell (``device_profile``
    rows), eager and graphed, by name: each name whose launches a step or
    device ms a step differ, with both, and the sums of the rest."""
    def by_name(rows):
        out = collections.defaultdict(lambda: [0.0, 0.0])
        for key, ms, cnt in rows:
            out[key][0] += cnt
            out[key][1] += ms
        return out

    a, b = by_name(eager), by_name(graphed)
    names = sorted(set(a) | set(b), key=lambda k: -abs(a[k][1] - b[k][1]))
    moved = [k for k in names if a[k][0] != b[k][0]
             or abs(a[k][1] - b[k][1]) > 1e-3]
    same = [k for k in names if k not in moved]
    print(f"{label} kernels by name, eager against graphed ({N_PROFILED} "
          f"steps): {len(names)} names, {len(moved)} differ in launches a "
          f"step or by over 1 us a step; the other {len(same)} "
          f"{sum(a[k][1] for k in same):.4f} and "
          f"{sum(b[k][1] for k in same):.4f} ms/step [{card}]", flush=True)
    for k in moved:
        print(f"  eager {a[k][0]:6.1f}x {a[k][1]:8.4f} ms/step, graphed "
              f"{b[k][0]:6.1f}x {b[k][1]:8.4f} ms/step  {k[:90]}",
              flush=True)


class OpNames(TorchDispatchMode):
    """Counts the ops dispatched, by name."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def dispatched(run) -> collections.Counter:
    """The ops ``run()`` dispatches, by name."""
    with OpNames() as names:
        run()
    torch.cuda.synchronize()
    return names.counts


def two_windows(label, rows_a, run, card):
    """A second profiled window of ``run()`` (``N_PROFILED`` steps) against
    the first, ``rows_a``: prints whether the kernels a step are the same
    by name, and which differ; then the ops two more calls dispatch, which
    must be the same (a path that differs between two calls is a
    fault)."""
    def per_step(rows):
        out = collections.Counter()
        for key, _, cnt in rows:
            out[key] += cnt
        return out

    a, b = per_step(rows_a), per_step(device_profile(run, N_PROFILED)[0])
    diff = {k: (a[k], b[k]) for k in set(a) | set(b) if a[k] != b[k]}
    line = (f"{label}: two profiled windows, {sum(a.values()):.1f} and "
            f"{sum(b.values()):.1f} kernels a step")
    if diff:
        line += ("; by name (first, second): " + "; ".join(
            f"{k[:70]} {x:.1f}, {y:.1f}" for k, (x, y) in sorted(
                diff.items())))
    else:
        line += f", the same in {len(a)} names"
    ops = [dispatched(run), dispatched(run)]
    if ops[0] != ops[1]:
        raise AssertionError(f"{label}: two calls dispatch other ops: "
                             f"{(ops[0] - ops[1]) + (ops[1] - ops[0])}")
    print(f"{line}; two more calls dispatch the same "
          f"{sum(ops[0].values())} ops ({sum(ops[0].values()) / N_PROFILED:.1f}"
          f" a step) [{card}]", flush=True)


def ranks_graphs_vs_eager(dev, card, label, case):
    """A cell of GRAPH_RANK_CELLS on N_RANKS ranks of this card, eager and
    then graphed, in float32: the same bits in the final state and every
    stream, one exchange and one ``table_stage`` and one ``fused_step``
    launch a step on each rank; each rank's ms/step, exchange share,
    capture ms and peak device memory in both modes.  Returns {mode: the
    ranks' numbers}."""
    from kid_tpu_torch.dist import launch
    from kid_tpu_torch.driver.loop import KidState, initial_state
    n, i0, names, warm = GRAPH_RANK_CELLS[label]
    dtype = torch.float32
    st0 = (KidState(*[t.to(dtype) for t in seeded_state(case, dev)])
           if i0 else initial_state(case, dtype, dev))
    runs, secs = {}, {}
    for mode, graphs in (("eager", False), ("graphed", True)):
        t0 = time.perf_counter()
        runs[mode] = launch.run_sharded(
            case, N_RANKS, n, dtype, *launch.default_layout(N_RANKS, dev),
            istep0=i0, state0=st0, profile_diags=names, warmup_steps=warm,
            graphs=graphs)
        secs[mode] = time.perf_counter() - t0
        check_ranks(f"{label} {mode}", runs[mode].ranks, n, graphs)
    e, g = runs["eager"], runs["graphed"]
    pairs = [*((f, g.fields[f], e.fields[f]) for f in KidState._fields),
             *((k, g.ppt[k], e.ppt[k]) for k in PPT)]
    if set(g.profiles) != set(e.profiles):
        raise AssertionError(f"{label} on ranks: streams differ")
    pairs += [(k, v, e.profiles[k]) for k, v in g.profiles.items()]
    for k, a, b in pairs:
        if not np.array_equal(a, b):
            raise AssertionError(f"{label} on {N_RANKS} ranks: graphed and "
                                 f"eager differ in {k}")
    check_finite_nonnegative(f"{label} on ranks", {
        k: torch.from_numpy(v) for k, v in (*g.fields.items(),
                                            *g.ppt.items())})
    ms = {m: float(np.mean([r["ms_per_step"] for r in runs[m].ranks]))
          for m in runs}
    print(f"graphs vs eager {label} ({case.nx}, {case.nz}) f32 on "
          f"{N_RANKS} ranks ({', '.join(r['device'] for r in g.ranks)}, "
          f"gloo), {n} steps from step {i0} after {warm} warm-up steps: the "
          f"same bits in the final state and {len(pairs) - 12} streams, one "
          f"exchange and one table_stage and one fused_step launch a step "
          f"on each rank; "
          + "; ".join(f"{m} ({secs[m]:.1f} s with spawning): "
                      f"{rank_line(runs[m].ranks)}" for m in runs)
          + f"; rank wall {ms['eager'] / ms['graphed']:.2f}x [{card}]",
          flush=True)
    return {m: runs[m].ranks for m in runs}


def phase_bench(dev):
    """One run of ``python -m kid_tpu_torch.bench`` in this process; its
    JSON line is printed as it prints it, then its graphed and eager
    solver-batch rates."""
    from kid_tpu_torch import bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([])
    print(buf.getvalue(), end="", flush=True)
    release_graphs()
    if rc != 0:
        raise AssertionError("bench failed")
    r = json.loads(buf.getvalue().strip().splitlines()[-1])
    graphed = r["synthetic_mixed_phase_r03_metric"]
    eager = r["synthetic_mixed_phase_eager"]
    print(f"bench solver batch ({r['ncol']}, 120) f32: graphed "
          f"{graphed:.0f} column-steps/s, eager {eager:.0f} "
          f"({graphed / eager:.2f}x)", flush=True)


def phase_oracle(dev, card):
    """The float64 kernel path on the card against the port's oracle twin
    on the host: mixed1 and aerosol1d for ORACLE_STEPS steps through
    graphed ``simulate`` (``fused_step``; ``fused_rates`` and
    ``fused_post``), scored with ``scores.score_against_oracle`` at
    ``RTOL`` (nc, nwfa, nifa at ``RTOL_AEROSOL_EXTRAS``); cumulus2d and
    orographic2d at ORACLE_2D through ``validation.twod.twin_equivalence``,
    closures included.  Returns {path: launches}."""
    from kid_tpu_torch.driver.cases import CASES
    from kid_tpu_torch.tables.cache import get_tables
    from kid_tpu_torch.validation import cases as V
    from kid_tpu_torch.validation import scores, twod
    from kid_tpu_torch.validation.driver_twin import oracle_simulate
    paths, failed = {}, []
    for name in ("mixed1", "aerosol1d"):
        case = CASES[name]
        t0 = time.perf_counter()
        fo, ppt = oracle_simulate(case, ORACLE_STEPS,
                                  get_tables(iiwarm=case.micro.iiwarm))
        twin_s = time.perf_counter() - t0
        final, rain, _, launches = V.run(case, torch.float64, ORACLE_STEPS,
                                         dev, profile=False)
        want = SPLIT if case.micro.is_aerosol_aware else STEP
        if launches != path_counts(launches, ORACLE_STEPS, want):
            raise AssertionError(f"oracle {name}: launches {launches}")
        e = scores.score_against_oracle(
            final, rain, {**fo, "ppt_rain": ppt["rain"]}, scores.RTOL,
            scores.RTOL_AEROSOL_EXTRAS)
        worst = max(e["fields"], key=e["fields"].get)
        print(f"oracle {name} f64 on the card, {ORACLE_STEPS} steps, against "
              f"the oracle twin on the host: worst field {worst} "
              f"{e['fields'][worst]:.3e} (targets "
              f"{e['worst_target_field_rel']:.3e}, limit {scores.RTOL:g}; "
              f"extras {e['worst_aerosol_extra_rel']:.3e}, limit "
              f"{scores.RTOL_AEROSOL_EXTRAS:g}), cumulative rain "
              f"{e['cum_ppt_rain_rel']:.3e}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; pass="
              f"{e['pass']} (twin {twin_s:.1f} s, all "
              f"{time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
        paths[f"oracle_{name}"] = launches
        if not e["pass"]:
            failed.append(name)
    for case in (CASES["cumulus2d"], CASES["orographic2d"]):
        e = twod.twin_equivalence(dataclasses.replace(case, nx=ORACLE_2D[0]),
                                  ORACLE_2D[1], dev)
        worst = max(e["fields"], key=e["fields"].get)
        print(f"oracle {twod.twin_line(case.name, e)}; worst field {worst}; "
              f"launches { {k: v for k, v in e['launches'].items() if v} } "
              f"[{card}]", flush=True)
        if e["launches"] != path_counts(e["launches"], ORACLE_2D[1], STEP):
            raise AssertionError(f"oracle {case.name}: launches "
                                 f"{e['launches']}")
        paths[f"oracle_{case.name}"] = e["launches"]
        if not e["pass"]:
            failed.append(case.name)
    if failed:
        raise AssertionError(f"against the oracle twin: {failed}")
    return paths


def phase_records(dev, card):
    """The port's measuring scripts on this card.  ``scaling``'s one-card
    rows: cumulus2d tiled to ``scaling.CARD["per_rank_nx"]`` (32768)
    columns, its 20 timed steps in one process and on one rank of
    ``dist.launch`` (its exchange in its graph), the same bits.  One
    white-noise member of ``validation.chaos`` on mixed1 for
    ``CHAOS_STEPS`` steps graphed (a CUDA graph of the noisy step, fresh
    noise each replay; its noise the same bits as the CPU's) and eager,
    the same bits, then the same through
    ``fused_kid_step`` (KID_TPU_TORCH_FUSED_DRIVER=1).  Then
    ``validation.cases --record`` (mixed1, float64, ``RECORD_STEPS``
    steps against the port's oracle twin) and ``validation.chaos
    --record`` into one temporary record, whose blocks and provenance are
    checked.  Returns {path: launches}."""
    from kid_tpu_torch import scaling
    from kid_tpu_torch.dist import launch
    from kid_tpu_torch.driver.cases import MIXED1
    from kid_tpu_torch.driver.loop import (BLOCKS, FUSED_DRIVER_ENV,
                                           initial_state)
    from kid_tpu_torch.micro.solver import device_tables
    from kid_tpu_torch.tables.cache import get_tables
    from kid_tpu_torch.validation import cases as V
    from kid_tpu_torch.validation import chaos
    paths = {}
    size = scaling.CARD
    nx = size["per_rank_nx"]
    reset_counts()
    one = scaling.one_process(nx, size["spin"], size["steps"], dev)
    paths[f"scaling_{nx}_one_process"] = read_counts()
    BLOCKS.clear()
    torch.cuda.empty_cache()
    row = scaling.sharded_row(one, nx, 1, size, launch.default_layout(1, dev))
    (launches,) = row["launches"]
    paths[f"scaling_{nx}_1_rank"] = launches
    want = size["steps"]
    if not row["bitwise_equal_to_one_process"] or launches["fused_step"] \
            != want or row["placement"] != ["step"]:
        raise AssertionError(f"scaling at {nx} columns on one rank: {row}")
    prof = row["profile"][0]
    print(f"scaling's one-card rows, cumulus2d tiled to ({nx}, 60) f32, "
          f"{want} steps from step {size['spin']}: one process "
          f"{one['ms_per_step']:.3f} ms/step, one rank (its exchange in its "
          f"graph) {row['ms_per_step']:.3f} ms/step, "
          f"{row['column_steps_per_sec']:.0f} column-steps/s, bit for bit "
          f"the one-process run, {launches['fused_step']} fused_step "
          f"launches; profiled: device {prof['device_ms']:.3f} ms/step, "
          f"{prof['host_exchange_calls']:.0f} host calls of the exchange a "
          f"step [{card}]", flush=True)

    case, dtype = MIXED1, torch.float32
    tables = device_tables(get_tables(iiwarm=False), dtype, dev)
    st0 = initial_state(case, dtype, dev)
    noise = chaos.CounterNoise((case.nx, case.nz), dev)
    on_host = chaos.CounterNoise((case.nx, case.nz), "cpu")
    for persistent in (True, False):
        noise.set(1, persistent)
        on_host.set(1, persistent)
        for step in (0, 1, CHAOS_STEPS - 1):
            noise.step.fill_(step)
            on_host.step.fill_(step)
            if not torch.equal(noise.draw(dtype).cpu(), on_host.draw(dtype)):
                raise AssertionError(f"CounterNoise at step {step} "
                                     f"(persistent={persistent}): the card "
                                     f"and the CPU draw other values")
    print(f"CounterNoise: the same bits on the card and the CPU, both "
          f"classes, steps 0, 1 and {CHAOS_STEPS - 1} [{card}]", flush=True)
    noise.set(1, False)
    for label, kernel, fused in (("chaos_mixed1", "fused_step", "0"),
                                 ("chaos_mixed1_fused_driver",
                                  "fused_kid_step", "1")):
        os.environ[FUSED_DRIVER_ENV] = fused
        try:
            got = {}
            for mode, graphs in (("eager", False), ("graphed", True)):
                reset_counts()
                t0 = time.perf_counter()
                got[mode] = to_host(chaos.run_member(
                    case, tables, st0, CHAOS_STEPS, noise, graphs))
                got[mode + "_s"] = time.perf_counter() - t0
                counts = read_counts()
                if counts != path_counts(counts, CHAOS_STEPS,
                                         ("advect", "table_stage", kernel)):
                    raise AssertionError(f"{label} {mode}: launches "
                                         f"{counts}")
        finally:
            os.environ.pop(FUSED_DRIVER_ENV, None)
        paths[label] = counts
        n_streams = same_bits(label, got["graphed"], got["eager"])
        plain = to_host(chaos.run_member(case, tables, st0, CHAOS_STEPS,
                                         graphs=True))
        moved = float((got["graphed"][0].qv.double()
                       - plain[0].qv.double()).abs().max()
                      / plain[0].qv.double().abs().max())
        if not moved > 0.0:
            raise AssertionError(f"{label}: the noise did not move qv")
        check_finite_nonnegative(label, got["graphed"][0]._asdict())
        print(f"chaos member (white noise, seed 1, eps {chaos.EPS:g}) of "
              f"mixed1 f32, {CHAOS_STEPS} steps through {kernel}: graphed "
              f"and eager the same bits in the final state and "
              f"{n_streams} streams, {counts[kernel]} launches; qv "
              f"{moved:.3e} from the unperturbed run; eager "
              f"{got['eager_s']:.1f} s, graphed {got['graphed_s']:.1f} s "
              f"(capture in it) [{card}]", flush=True)

    with tempfile.TemporaryDirectory(prefix="kid_record_") as d:
        path = Path(d) / "VALIDATION.json"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = V.main(["--cases", "mixed1", "--steps", str(RECORD_STEPS),
                         "--dtype", "float64", "--write-finals", d,
                         "--device", str(dev), "--record", str(path)])
            rc_chaos = chaos.main(["mixed1", "--steps", str(RECORD_STEPS),
                                   "--device", str(dev), "--record",
                                   str(path)])
        r = json.loads(path.read_text())
        want_keys = {"fp64", "rtol", "fp64_all_pass", "chaos_envelope",
                     "hardware", "commit", "source_sha256", "runs"}
        env = r["chaos_envelope"]["cases"]["mixed1"]
        if (rc, rc_chaos) != (0, 0) or not want_keys <= set(r) \
                or not r["fp64_all_pass"] \
                or any(env.get(kind, {}).get("members") != len(chaos.SEEDS)
                       for kind in chaos.KINDS) \
                or r["hardware"]["device"] != torch.cuda.get_device_name(0) \
                or not r["hardware"]["cards"]:
            raise AssertionError(f"--record: exit codes {rc}, {rc_chaos}; "
                                 f"{sorted(r)}; {buf.getvalue()[-2000:]}")
        e = r["fp64"]["mixed1"]
        paths["record_fp64_mixed1"] = e["launches"]
        print(f"--record: validation.cases (mixed1 f64, {RECORD_STEPS} "
              f"steps, worst target {e['worst_target_field_rel']:.3e} "
              f"against the twin) and validation.chaos (mixed1, "
              f"{RECORD_STEPS} steps, 3 members of each class: white cum_ppt "
              f"{env['white_noise']['cum_ppt_spread']:.3e}) merged into one "
              f"record: {', '.join(sorted(r))}; hardware "
              f"{r['hardware']['cards']} [{card}]", flush=True)
    return paths


def timed(phase, fn, *args):
    """``fn(*args)``, with the phase's seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from kid_tpu_torch.micro import cuda_build
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"kernel build ({', '.join(kernels())}, in parallel): "
          f"{cuda_build.build():.1f} s", flush=True)
    res = phase_resources()
    digests, paths = {}, {}
    phase_kernel_vs_plain(dev, digests)
    phase_split_vs_plain(dev, digests)
    phase_kid_step_vs_plain(dev, digests)
    timed("2d", phase_kernel_vs_plain, dev, digests, VS_PLAIN_2D,
          "fused_step nz=60")
    records, default_ms, paths["mixed1"], x_mixed = phase_main_path(
        dev, card, res)
    aerosol, paths["aerosol1d"], x_aero = phase_aerosol_main_path(dev, card,
                                                                  res)
    fused, paths["fused_driver_mixed1"] = phase_fused_driver_main_path(
        dev, card, default_ms, res)
    records = [timed("2e", phase_table_stage, dev, card, digests,
                     paths["mixed1"]["table_stage"], x_mixed, x_aero),
               timed("2f", phase_advect, dev, card, digests,
                     paths["mixed1"]["advect"], res["advect"]),
               timed("2g", phase_lookup_stage, dev, card, digests,
                     paths["aerosol1d"]["lookup_stage"],
                     res["lookup_stage"]),
               *records, *aerosol, *fused]
    del x_mixed, x_aero
    timed("4", phase_end_to_end, dev)
    phase_fused_driver_end_to_end(dev)
    paths.update(timed("5", phase_2d, dev, card))
    paths["mp_driver_3d"] = timed("5b", phase_wrf, dev, card)
    paths.update(timed("5b batched", phase_batched, dev, card))
    paths["cumulus2d_2_ranks"] = timed("6a", phase_sharded_2d, dev, card)
    paths["flagship_window"] = timed("6b", phase_flagship, dev, card)
    paths["cumulus2d_1_rank_in_step"] = timed(
        "6c", phase_one_rank_in_step, dev, card)
    validation = timed("7", phase_validation, dev, card)
    timed("8", phase_bench, dev)
    timed("9", phase_graphs_vs_eager, dev, card)
    paths.update(timed("10", phase_oracle, dev, card))
    timed("11", phase_cli, dev, card)
    paths.update(timed("12", phase_records, dev, card))
    paths.update({f"validation_{k}": v for k, v in validation.items()})
    for name, counts in paths.items():
        for r in records:
            if counts[r["name"]]:
                r.setdefault("launches_by_path", {})[name] = counts[r["name"]]
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
