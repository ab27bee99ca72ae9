"""The comparison that decides ``correct``.

Each answer compared is a state the program produced from a state
before it (a few steps of the loop, or one call), both taken from the
timed path.  The reference follows the same steps from the same state
before.  For each field the gap is the relative L2 distance of the
increments over the sampled cells,

    gap = || prog - ref || / max(|| ref - before ||, FLOOR * || ref ||),

where the floor keeps a field that barely moves (the forced droplet
number, the inert aerosol fields) from being judged finer than a part in
10^4 of its own size; 0 where both sides are 0, and ``NONE_SUCH`` (a
finite stand-in for infinity, which JSON cannot hold) where the program
moved a field the reference left at 0, or produced a non-finite value.
A program that returns its state unchanged reads 1 on every field that
moves by more than the floor; rounding in float32 reads far below that;
a state held in bfloat16 reads far above 1, since its rounding is larger
than a step's increment.  The number compared is the worst field's gap
over every answer (``worst_gap``), with, over all the columns the timed
path produced, the count of non-finite values (``nonfinite``, limit
0)."""
from __future__ import annotations

import math

import numpy as np


FLOOR = 1.0e-4
NONE_SUCH = 1.0e300


def norm(a) -> float:
    return float(np.sqrt(np.sum(np.square(a))))


def field_gap(before, prog, ref) -> float:
    """The gap of one field (arrays of one shape; ``before`` may be 0 for
    a quantity that accumulates)."""
    ref = np.asarray(ref, np.float64)
    num = norm(np.asarray(prog, np.float64) - ref)
    den = max(norm(ref - before), FLOOR * norm(ref))
    if not math.isfinite(num):
        return NONE_SUCH
    if den > 0.0:
        return num / den
    return 0.0 if num == 0.0 else NONE_SUCH


def gaps(before: dict, prog: dict, ref: dict) -> dict:
    """``field_gap`` of every field of ``ref`` (``before`` lacks the
    accumulated ones, which start from 0)."""
    return {k: field_gap(before.get(k, 0.0), prog[k], ref[k]) for k in ref}


def worst(named_gaps: dict) -> tuple:
    """(the largest gap, 'answer/field' where it is) of
    {answer: {field: gap}}."""
    best = (0.0, "none")
    for answer, fields in named_gaps.items():
        for field, g in fields.items():
            if g > best[0]:
                best = (g, f"{answer}/{field}")
    return best
