"""The chaos envelope of the 1-D cases: how far per-step noise at the
float32 rounding scale carries a run (the port's counterpart of
``prof/prof_chaos_ppt.py``).

    python -m kid_tpu_torch.validation.chaos [case ...] \\
        [--record VALIDATION_h100.json]
    python -m kid_tpu_torch.validation.chaos mixed1 --device cpu --steps 20

A float32 run on another backend differs from the oracle by rounding
kicks of ~1 ulp in every field at every step.  This ensemble injects that
class of perturbation on purpose: after each step every one of the 12
``KidState`` fields is multiplied by ``1 + eps * U(-1, 1)`` (eps 1e-7,
float32's ulp is 6e-8), in float32, at the case's full length.  Two
classes, 3 members each (seeds 1-3), against the unperturbed run:
``white_noise`` draws fresh noise every step (a random walk),
``persistent_bias`` the same pattern every step (a backend's
deterministic rounding, which re-flips the same near-edge cells).  Per
class it reports the worst over the members of ``cum_ppt_spread`` (the
cumulative rain series), ``final_field_spread`` and
``tmean_profile_spread`` (the nine target fields' finals and time-mean
profiles), each relative to the unperturbed run's largest magnitude, as
``prof_chaos_ppt.py:86-111`` computes them.  The reference's f32 budgets
are fixed at about twice these envelopes.

The noisy step wraps ``driver.loop.make_step``'s step and runs in a
``StepLoop`` driven by ``loop.drive``; on the card a ``CapturedStep``
replays it, one capture a case for all six members.  So that each replay
draws fresh noise, the noise reads and advances device tensors only:
``CounterNoise`` hashes (seed, class, its own device step counter, field,
cell) with int64 torch ops, which give the same bits on the CPU and the
card.  Its values are not ``jax.random``'s: the envelope is a
statistic of the ensemble.  ``--record PATH`` merges the
``chaos_envelope`` block into the JSON record at PATH.  Without a card it
exits 2 unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import records
from ..device import resolve_device
from ..driver.cases import CASES
from ..driver.loop import (BLOCKS, CapturedStep, KidState, StepLoop, drive,
                           initial_state, make_step)
from ..micro import cuda_build
from ..micro.graphs import GRAPH_DEVICE_TYPES
from ..micro.solver import device_tables
from ..tables.cache import get_tables
from .scores import TARGET_FIELDS

EPS = 1.0e-7
SEEDS = (1, 2, 3)
# class -> persistent
KINDS = {"white_noise": False, "persistent_bias": True}
DEFAULT_CASES = ("aerosol1d", "mixed1", "warm1")
WHAT = ("per-step multiplicative 1e-7 noise on ALL prognostic fields, in "
        "float32 on this device: the perturbation class a different "
        "backend's deterministic rounding injects; the reference's f32 pass "
        "budgets are fixed at ~2x these envelopes (validate_cases_f32.py "
        "docstring)")

_MASK = 0xFFFFFFFF
# the two odd multipliers of a 32-bit integer hash, both under 2**31, so
# that a product with a 32-bit value fits an int64 without overflow
_M1, _M2 = 0x21F0AAAD, 0x735A2D97


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2**32), elementwise."""
    x = x ^ (x >> 16)
    x = (x * _M1) & _MASK
    x = x ^ (x >> 15)
    x = (x * _M2) & _MASK
    return x ^ (x >> 15)


class CounterNoise:
    """U(-1, 1) values for every field and cell of a step, a function of
    (seed, class, step, field, cell) alone.  ``set`` picks the member
    (seed and class) by filling device tensors and ``restart`` puts the
    device step counter ``step`` at 0; ``draw`` reads the values at
    ``step`` and adds one to it, device tensors only, so a captured step
    that calls it draws anew at each replay.  ``persistent`` members draw
    the same values at every step."""

    def __init__(self, shape: tuple, device):
        self.seed = torch.zeros(1, dtype=torch.long, device=device)
        self.white = torch.ones(1, dtype=torch.long, device=device)
        self.step = torch.zeros(1, dtype=torch.long, device=device)
        n = len(KidState._fields)
        self.cells = mix32(torch.arange(n * shape[0] * shape[1],
                                        dtype=torch.long, device=device)
                           .reshape(n, *shape))

    def set(self, seed: int, persistent: bool):
        self.seed.fill_(seed & _MASK)
        self.white.fill_(0 if persistent else 1)
        self.restart()

    def restart(self):
        self.step.zero_()

    def draw(self, dtype) -> torch.Tensor:
        """(12, nx, nz) values in [-1, 1) of ``dtype`` at ``step``, which
        then moves on by one."""
        key = mix32(mix32(self.seed * 2 + self.white)
                    ^ (self.step * self.white))
        self.step.add_(1)
        bits = mix32(self.cells ^ key)
        return (bits >> 8).to(dtype) * 2.0 ** -23 - 1.0


def noisy_step(step, noise, eps: float):
    """``step`` (of ``make_step``) with each field of its new state times
    ``1 + eps * u``, u ``noise.draw``'s next values; the precip and the
    profiles are the step's own, as in the reference."""
    def stepped(st, m):
        new, ppt, profs = step(st, m)
        u = noise.draw(new.qv.dtype)
        return KidState(*[x * (1.0 + eps * u[i])
                          for i, x in enumerate(new)]), ppt, profs
    return stepped


def member_loop(case, tables, state0: KidState, noise=None,
                eps: float = EPS) -> StepLoop:
    """A ``StepLoop`` of ``case``'s step on ``state0``'s device and dtype,
    with the ``TARGET_FIELDS`` streams, wrapped in ``noisy_step`` where
    ``noise`` is given; its ``state`` is ``state0``."""
    dtype, dev = state0.qv.dtype, state0.qv.device
    fl = BLOCKS.get(case, dtype, dev).flow
    step = make_step(case, tables, dtype, dev, fl.w_pat, fl.u_pat, fl.pres2,
                     None, TARGET_FIELDS)
    if noise is not None:
        step = noisy_step(step, noise, eps)
    loop = StepLoop(step, tuple(state0.qv.shape), dtype, dev, TARGET_FIELDS)
    loop.state = state0
    return loop


def _host(result) -> dict:
    """(final fields, rain series of column 0, time-mean profiles) of a
    ``drive`` result, as float64 numpy."""
    final, out = result
    return {"final": {f: getattr(final, f).double().cpu().numpy()
                      for f in KidState._fields},
            "rain": out.ppt_rain[:, 0].double().cpu().numpy(),
            "tmean": {f: v.double().cpu().numpy().mean(0)
                      for f, v in out.profiles.items()}}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def spreads(member: dict, base: dict) -> dict:
    """A member against the unperturbed run (``prof_chaos_ppt.py:86-111``):
    the cumulative rain series and the worst target field's final and
    time-mean profile, each relative to the unperturbed run's scale."""
    return {"cum_ppt_spread": _rel(member["rain"].cumsum(),
                                   base["rain"].cumsum()),
            "final_field_spread": max(_rel(member["final"][f],
                                           base["final"][f])
                                      for f in TARGET_FIELDS),
            "tmean_profile_spread": max(_rel(member["tmean"][f],
                                             base["tmean"][f])
                                        for f in TARGET_FIELDS)}


def envelope(name: str, device="cuda", n_steps=None) -> dict:
    """The chaos envelope of case ``name`` in float32: the unperturbed
    run, then ``SEEDS`` members of each class of ``KINDS`` at ``EPS``, all
    from the initial sounding for ``n_steps`` (default: the case's
    length).  On a card the noisy step is captured once and replayed for
    every member.  Returns {class: spreads, members, eps}, plus the kernel
    launches of all the runs and the seconds."""
    dev = resolve_device(device)
    case, dtype = CASES[name], torch.float32
    n = case.n_steps if n_steps is None else n_steps
    t0 = time.perf_counter()
    tables = device_tables(get_tables(iiwarm=case.micro.iiwarm), dtype, dev)
    st0 = initial_state(case, dtype, dev)
    cuda_build.reset_launch_counts()
    base = _host(run_member(case, tables, st0, n))
    noise = CounterNoise((case.nx, case.nz), st0.qv.device)
    loop = member_loop(case, tables, st0, noise)
    captured = None
    if st0.qv.device.type in GRAPH_DEVICE_TYPES:
        captured = CapturedStep(loop, st0, None, tables)
    out = {}
    for kind, persistent in KINDS.items():
        worst = dict.fromkeys(("cum_ppt_spread", "final_field_spread",
                               "tmean_profile_spread"), 0.0)
        for seed in SEEDS:
            noise.set(seed, persistent)
            if captured is not None:
                captured.load(st0)
                result = drive(loop, captured.run, case, n, 0)
            else:
                loop.state = st0
                result = drive(loop, loop.run, case, n, 0)
            s = spreads(_host(result), base)
            worst = {k: max(v, s[k]) for k, v in worst.items()}
        out[kind] = {**worst, "members": len(SEEDS), "eps": EPS}
    out.update(n_steps=n, dtype=str(dtype)[6:],
               launches=cuda_build.launch_counts(),
               seconds=time.perf_counter() - t0)
    return out


def run_member(case, tables, state0: KidState, n_steps: int, noise=None,
               graphs: bool = True, eps: float = EPS):
    """One run of ``n_steps`` from ``state0`` (unperturbed where ``noise``
    is None; else ``noise``'s member as ``set``, from its first step):
    captured and replayed on a card with ``graphs``, eager otherwise.
    Returns ``drive``'s (final KidState, StepOutputs) of the target
    streams."""
    loop = member_loop(case, tables, state0, noise, eps)
    run = loop.run
    if graphs and state0.qv.device.type in GRAPH_DEVICE_TYPES:
        captured = CapturedStep(loop, state0, None, tables)
        captured.load(state0)
        run = captured.run
    if noise is not None:
        noise.restart()          # the capture's warm-up step drew once
    return drive(loop, run, case, n_steps, 0)


def line(name: str, e: dict) -> str:
    return "; ".join(
        f"{name}: per-step-1e-7 {kind} ensemble ({e[kind]['members']} "
        f"members): cum_ppt spread {e[kind]['cum_ppt_spread']:.3e}, field "
        f"spread {e[kind]['final_field_spread']:.3e}, tmean-profile spread "
        f"{e[kind]['tmean_profile_spread']:.3e}" for kind in KINDS) + (
        f" ({e['n_steps']} steps, {e['seconds']:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kid_tpu_torch.validation.chaos",
        description="The per-step noise ensemble of the 1-D cases.")
    ap.add_argument("cases", nargs="*", default=list(DEFAULT_CASES),
                    help=f"(default: {' '.join(DEFAULT_CASES)})")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps of every run (default: the case's length)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="merge the chaos_envelope block into this JSON "
                         "record")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"chaos: {e}", file=sys.stderr)
        return 2
    cases = {}
    for name in args.cases:
        cases[name] = envelope(name, dev, args.steps)
        print(line(name, cases[name]), flush=True)
    if args.record:
        records.merge(args.record, {"chaos_envelope": {
            "what": WHAT, "device": str(dev), "cases": cases}}, dev)
    print(json.dumps({"chaos_envelope": {
        k: {kind: e[kind] for kind in KINDS} for k, e in cases.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
