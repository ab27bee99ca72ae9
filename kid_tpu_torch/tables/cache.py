"""Content-addressed on-disk cache for the lookup tables (twin of
``kid_tpu/tables/cache.py``, same fingerprint scheme, own directory).

Mirrors the reference's run_data/*.data cache (module_mp_thompson09n.f90:
3710-3728, 3857-3895), keyed by a hash of the constants that feed the
builders so a constant change invalidates the cache.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from .. import constants as c
from .. import spans
from .builders import Tables, build_all_tables

_CACHE_VERSION = 1


def constants_fingerprint() -> str:
    """Hash of every constant that feeds a table builder."""
    h = hashlib.sha256()
    h.update(str(_CACHE_VERSION).encode())
    for v in (c.AM_R, c.BM_R, c.AM_S, c.BM_S, c.AM_G, c.BM_G, c.AM_I, c.BM_I,
              c.AV_R, c.BV_R, c.FV_R, c.AV_S, c.BV_S, c.FV_S, c.AV_G, c.BV_G,
              c.MU_R, c.MU_G, c.MU_I, c.MU_S, c.KAP0, c.KAP1, c.LAM0, c.LAM1,
              c.EF_RS, c.EF_RG, c.D0C, c.D0R, c.D0S, c.D0G, c.D0I,
              c.XM0G, c.RHO_W):
        h.update(np.float64(v).tobytes())
    for a in (c.R_C_AXIS, c.R_I_AXIS, c.R_R_AXIS, c.R_S_AXIS, c.R_G_AXIS,
              c.N0R_EXP_AXIS, c.N0G_EXP_AXIS, c.NT_I_AXIS, c.TC_AXIS,
              c.SA, c.SB, c.T_NC):
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()[:16]


def default_cache_dir() -> str:
    return os.environ.get(
        "KID_TPU_TORCH_TABLE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "kid_tpu_torch"))


def get_tables(iiwarm: bool = False, cache_dir: Optional[str] = None,
               use_cache: bool = True) -> Tables:
    """Load tables from the cache, or build and persist them (the span
    ``kid.setup.tables``)."""
    with spans.span("kid.setup.tables"):
        return _get_tables(iiwarm, cache_dir, use_cache)


def _get_tables(iiwarm: bool, cache_dir: Optional[str],
                use_cache: bool) -> Tables:
    if not use_cache:
        return build_all_tables(iiwarm)
    cache_dir = cache_dir or default_cache_dir()
    key = f"thompson09_{constants_fingerprint()}_{'warm' if iiwarm else 'full'}"
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return Tables(**{k: z[k] for k in Tables._fields})
        except (OSError, ValueError, KeyError):
            pass  # corrupt cache: rebuild
    tables = build_all_tables(iiwarm)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        # tmp must end in .npz or np.savez appends it and os.replace misses
        tmp = path + f".tmp.{os.getpid()}.npz"
        np.savez_compressed(tmp, **tables._asdict())
        os.replace(tmp, path)
    except OSError:
        pass  # read-only filesystem: run without persisting
    return tables
