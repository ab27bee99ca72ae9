"""The measured denominator of the bench's ``vs_baseline`` (the port's
counterpart of ``bench_baseline.py``): column-steps/s of one CPU core
running the Thompson scheme at nz=120, mixed phase.

    python -m kid_tpu_torch.baseline [--record BENCH_h100.json]   # card host
    python -m kid_tpu_torch.baseline --device cpu

The reference publishes no numbers, so the denominator rests on two
anchors, both measured on the host that runs this:

- Anchor A, the compiled floor of a cell-step: a C loop charging one
  mixed-phase level's 120 pow, 25 exp, 11 sqrt and 250 multiply-adds
  (the reference's hot path, module_mp_thompson09n.f90:1156-3688),
  built with ``gcc -O3 -march=native`` into a temporary directory.
- Anchor B, the port's NumPy oracle (``validation/oracle.py``, a scalar
  transliteration of ``mp_thompson``) on one seeded column; compiled
  code is taken to be at most 100x faster than it.

``BASELINE_COL_STEPS_PER_SEC`` (1.0e4, 3x anchor A as the reference
measured it, so as to favour the reference) is the denominator
``bench.py`` divides by.  Prints both anchors and one JSON line;
``--record PATH`` merges that line into the record at PATH as its
``baseline`` block (``records.merge``), beside the bench's.  Without a card
it exits 2 unless ``--device cpu``: the card's host is the one whose
anchors stand beside the card's numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import records
from .device import resolve_device
from .tables.cache import get_tables
from .validation.oracle import mp_thompson_oracle

BASELINE_COL_STEPS_PER_SEC = 1.0e4
NZ = 120
ORACLE_FACTOR = 100.0     # compiled code over the interpreted oracle, at most

_C_SRC = r"""
#include <math.h>
#include <stdio.h>
#include <time.h>
int main(void) {
    const int cells = 200000;
    volatile double sink = 0.0;
    double x = 1.2345, acc = 0.0;
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int c = 0; c < cells; ++c) {
        double v = x + 1e-9 * c;
        double a = 0.0;
        for (int i = 0; i < 120; ++i)
            a += pow(v + 1e-6 * i, 0.654321 + 1e-4 * i);
        for (int i = 0; i < 25; ++i)
            a += exp(-1e-3 * (v + i));
        for (int i = 0; i < 11; ++i)
            a += sqrt(v + i);
        for (int i = 0; i < 250; ++i)
            a = a * 1.0000001 + 1e-12;
        acc += a;
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    sink = acc; (void)sink;
    double ns = ((t1.tv_sec - t0.tv_sec) * 1e9
                 + (t1.tv_nsec - t0.tv_nsec)) / cells;
    printf("%.1f\n", ns);
    return 0;
}
"""


def anchor_a_c_cell_ns() -> float:
    """Build and run the C cell loop; returns ns per cell-step."""
    with tempfile.TemporaryDirectory(prefix="kid_baseline_") as d:
        src, exe = Path(d) / "cell.c", Path(d) / "cell"
        src.write_text(_C_SRC)
        subprocess.run(["gcc", "-O3", "-march=native", "-o", str(exe),
                        str(src), "-lm"], check=True)
        out = subprocess.run([str(exe)], capture_output=True, text=True,
                             check=True)
    return float(out.stdout.strip())


def profile(nz: int, seed: int, warm: bool = False) -> dict:
    """A seeded, physically plausible column with every species (a copy
    of the reference's ``tests/test_oracle.py::_profile``)."""
    rng = np.random.default_rng(seed)
    zf = np.linspace(0.0, 1.0, nz)
    t = 292.0 - 62.0 * zf + rng.normal(0.0, 0.4, nz)
    p = 98000.0 * np.exp(-1.25 * zf)
    qv = np.clip(0.8 * 0.622 * 611.2
                 * np.exp(17.27 * (t - 273.15) / np.maximum(t - 35.9, 1.0))
                 / p, 1e-6, 0.02)

    def blob(lo, hi, mag):
        m = np.zeros(nz)
        sl = (zf >= lo) & (zf <= hi)
        m[sl] = mag * (1.0 + 0.5 * rng.random(sl.sum()))
        return m

    qc = blob(0.1, 0.5, 6e-4)
    qr = blob(0.0, 0.35, 3e-4)
    if warm:
        qi = qs = qg = np.zeros(nz)
    else:
        qi = blob(0.55, 0.95, 6e-5)
        qs = blob(0.4, 0.9, 2.5e-4)
        qg = blob(0.25, 0.7, 1.5e-4)
    ni = np.where(qi > 0, 8e4 * (1 + rng.random(nz)), 0.0)
    nr = np.where(qr > 0, 2e5 * (1 + rng.random(nz)), 0.0)
    rho = 0.622 * p / (287.04 * t * (qv + 0.622))
    nc = 100.0e6 / rho
    nwfa = 11.1e6 / rho
    nifa = np.full(nz, 0.5e6 * 0.01)
    dz = np.full(nz, 200.0)
    w = np.zeros(nz)
    return dict(t=t, p=p, qv=qv, qc=qc, qr=qr, qi=qi, qs=qs, qg=qg,
                ni=ni, nr=nr, nc=nc, nwfa=nwfa, nifa=nifa, dz=dz, w=w)


def anchor_b_oracle_col_steps(nz: int = NZ, reps: int = 10) -> float:
    """The port's NumPy oracle on ``profile(nz, seed=3)``, one warm call
    then ``reps`` timed; returns column-steps/s."""
    prof = profile(nz, seed=3)
    kw = dict(qv1d=prof["qv"], qc1d=prof["qc"], qi1d=prof["qi"],
              qr1d=prof["qr"], qs1d=prof["qs"], qg1d=prof["qg"],
              ni1d=prof["ni"], nr1d=prof["nr"], nc1d=prof["nc"],
              nwfa1d=prof["nwfa"], nifa1d=prof["nifa"], t1d=prof["t"],
              p1d=prof["p"], w1d=prof["w"], dzq=prof["dz"], dt=10.0,
              tables=get_tables(iiwarm=False), iiwarm=False)
    mp_thompson_oracle(**kw)
    t0 = time.perf_counter()
    for _ in range(reps):
        mp_thompson_oracle(**kw)
    return reps / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m kid_tpu_torch.baseline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the card's host) or 'cpu'")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="merge the line into this JSON record")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"baseline: {e}", file=sys.stderr)
        return 2
    ns = anchor_a_c_cell_ns()
    a = 1e9 / (ns * NZ)
    print(f"anchor A (C speed-of-light): {ns:.1f} ns/cell -> {a:,.0f} "
          f"column-steps/s at nz={NZ}", flush=True)
    b = anchor_b_oracle_col_steps()
    print(f"anchor B (NumPy oracle): {b:.2f} column-steps/s -> <= "
          f"{b * ORACLE_FACTOR:,.0f} with a {ORACLE_FACTOR:g}x interpreter "
          f"factor", flush=True)
    line = {"anchor_a_ns_per_cell": ns, "anchor_a_col_steps_per_sec": a,
            "anchor_b_oracle_col_steps_per_sec": b,
            "anchor_b_bound_col_steps_per_sec": b * ORACLE_FACTOR,
            "baseline_col_steps_per_sec": BASELINE_COL_STEPS_PER_SEC,
            "baseline_over_anchor_a": BASELINE_COL_STEPS_PER_SEC / a,
            "nz": NZ}
    if args.record:
        records.merge(args.record, {"baseline": line}, dev)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
