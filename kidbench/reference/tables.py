"""The reference's lookup tables: built by the frozen builders
(``builders.py``, some seconds on a CPU) and cached, compressed, in a
fixed directory of the checkout, ``build/kidbench/reference_tables/``,
under a key that hashes the builders and the constants."""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

from .builders import Tables, build_all_tables

HERE = Path(__file__).resolve().parent
CACHE_DIR = HERE.parents[1] / "build" / "kidbench" / "reference_tables"


def cache_key(iiwarm: bool) -> str:
    h = hashlib.sha256()
    for name in ("builders.py", "constants.py"):
        h.update((HERE / name).read_bytes())
    return f"{'warm' if iiwarm else 'full'}_{h.hexdigest()[:16]}"


def get_tables(iiwarm: bool) -> Tables:
    """The host tables (float64 numpy) of the warm or the full scheme."""
    path = CACHE_DIR / f"{cache_key(iiwarm)}.npz"
    if path.exists():
        with np.load(path) as z:
            return Tables(**{k: z[k] for k in Tables._fields})
    tables = build_all_tables(iiwarm)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.stem + f".{os.getpid()}.tmp.npz")
    np.savez_compressed(tmp, **tables._asdict())
    os.replace(tmp, path)
    return tables
