"""Phases 2-20 of the microphysics step as one hand-written CUDA kernel.

``fused_step`` replaces ``kid_tpu/micro/pallas_step.py::fused_step`` (the
Pallas TPU kernel).  For a CUDA tensor it launches the kernel of
``csrc/fused_step.cu``; for a CPU tensor it runs ``fused_step_ref``, the
plain PyTorch version (``solver.core_from_tables``).  There is no fallback
between the two: a CUDA tensor either launches the kernel or raises.

The kernel is compiled with ``nvcc`` at first use into ``build/`` at the
repository root, keyed by a hash of its source, the constants header that
``constants_header`` generates from ``kid_tpu_torch/constants.py`` (one
source of truth for the physical constants) and the compiler flags; it is
bound through a plain C interface with ``ctypes``.  ``fused_step.launches``
counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import constants as c
from ..config import MicroConfig
from ..special import _RSIF_C, _RSLF_C
from . import solver as S
from .state import ColumnState, Precip

_SRC = Path(__file__).parent / "csrc" / "fused_step.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kid_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
N_STATE = len(ColumnState._fields)
MAX_NZ = 256          # one thread per level: the kernel's largest block

# the moment orders of the snow Field regression, as solver._prologue
# and solver._post_rates pass them
_FIELD_ORDERS = (("FM0", 0.0), ("FM1", 1.0), ("FMC", float(c.CSE[1])),
                 ("FME", float(c.CSE[13])), ("FMF", float(c.CSE[16])))


def _lit(v) -> str:
    """Exact C++ double literal."""
    v = float(v)
    if math.isinf(v) or math.isnan(v):
        raise ValueError(v)
    return float.hex(v)


def constants_header() -> str:
    """The kernel's constants: every scalar of ``constants.py``, the
    elements of its short 1-D arrays as ``NAME_i``, and the few values the
    solver derives in Python (each computed here exactly as the solver's
    Python computes it)."""
    lines = ["// generated by kid_tpu_torch/micro/fused_step.py; do not edit",
             "#pragma once", f"constexpr int MAX_NZ = {MAX_NZ};"]
    for name in sorted(dir(c)):
        if not name.isupper() or name.startswith("_"):
            continue
        v = getattr(c, name)
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float, np.floating, np.integer)):
            lines.append(f"constexpr double {name} = {_lit(v)};")
        elif (isinstance(v, np.ndarray) and v.ndim == 1 and v.size <= 64
              and np.issubdtype(v.dtype, np.floating)):
            for i, e in enumerate(v):
                lines.append(f"constexpr double {name}_{i} = {_lit(e)};")
    derived = {
        "RR1": c.R_R_AXIS[0], "RS1": c.R_S_AXIS[0], "RG1": c.R_G_AXIS[0],
        "LAMG_FAC": (S.CGG[3] * c.OGG2 * c.OGG1) ** c.OBMG,
        "D0R_CUBED": c.D0R ** 3,
        "LN10_PY": 2.302585092994046,
        "INV_LN10_PY": 0.4342944819032518,
        "INV_LN10_SNOW": 1.0 / math.log(10.0),
    }
    # powc(CIE[2] / D, BM_I) on a Python float: binary squaring
    for tag, d in (("25", 25.0e-6), ("5", 5.0e-6), ("300", 300.0e-6)):
        x = S.CIE[2] / d
        derived[f"P_ICE_{tag}"] = x * (x * x)
    for tag, m in _FIELD_ORDERS:
        derived[f"{tag}_M"] = m
        derived[f"{tag}_M3"] = m ** 3
    for i, v in enumerate(_RSLF_C):
        derived[f"RSLF_C_{i}"] = v
    for i, v in enumerate(_RSIF_C):
        derived[f"RSIF_C_{i}"] = v
    for k, v in derived.items():
        lines.append(f"constexpr double {k} = {_lit(v)};")
    rows = ",\n  ".join("{" + ", ".join(_lit(v) for v in r) + "}"
                        for r in S.NUC_COEF)
    lines.append(f"__device__ const double NUC_COEF[{len(S.NUC_COEF)}][6] "
                 f"= {{\n  {rows}}};")
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the fused_step kernel")


class _Library:
    """The compiled kernel library, built once per process."""

    def __init__(self):
        self._lib = None
        self.build_seconds = None

    def get(self):
        if self._lib is None:
            self._lib = self._load(self._build())
        return self._lib

    def _build(self) -> Path:
        header = constants_header()
        key = hashlib.sha256(_SRC.read_bytes() + header.encode()
                             + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = BUILD_DIR / key
        so = out_dir / "libfused_step.so"
        if so.exists():
            self.build_seconds = 0.0
            return so
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "fused_step_constants.h").write_text(header)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            tmp_so = Path(tmp) / "libfused_step.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(out_dir), "-o",
                   str(tmp_so), str(_SRC)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + res.stdout
                                   + res.stderr)
            os.replace(tmp_so, so)
        self.build_seconds = time.perf_counter() - t0
        return so

    @staticmethod
    def _load(so: Path):
        lib = ctypes.CDLL(str(so))
        for name in ("kid_fused_step_f32", "kid_fused_step_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_double,
                           ctypes.c_double, ctypes.c_double, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        return lib


_LIBRARY = _Library()


def build() -> float:
    """Build (or load) the kernel library; returns the build seconds."""
    _LIBRARY.get()
    return _LIBRARY.build_seconds


def pack_inputs(state: ColumnState, pres, dzq, tv, cfg: MicroConfig):
    """The kernel's one contiguous input, (14 + ntv, ncol, nz): the 12
    state channels, pres, dzq and the ``solver.tv_keys(cfg)`` channels."""
    shape = state.qv.shape
    chans = [*state, pres, dzq] + [tv[k] for k in S.tv_keys(cfg)]
    return torch.stack([torch.broadcast_to(t, shape) for t in chans])


def launch_packed(x, cfg: MicroConfig, dt_f: float, want_rates: bool):
    """Launch the kernel on the packed input ``x`` (see ``pack_inputs``)
    on the current stream, without synchronising.  Returns ``y``
    (12 [+36], ncol, nz) and ``ppt`` (4, ncol) as new tensors."""
    if x.device.type != "cuda":
        raise ValueError(f"launch_packed needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_step takes float32 or float64, not {x.dtype}")
    if cfg.is_aerosol_aware:
        raise NotImplementedError(S._AEROSOL_TODO)
    n_in = N_STATE + 2 + len(S.tv_keys(cfg))
    if x.dim() != 3 or x.shape[0] != n_in:
        raise ValueError(f"packed input must be ({n_in}, ncol, nz), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("packed input must be contiguous")
    _, ncol, nz = x.shape
    if not 2 <= nz <= MAX_NZ or ncol < 1:
        raise ValueError(f"fused_step takes 2 <= nz <= {MAX_NZ} and "
                         f"ncol >= 1, got ({ncol}, {nz})")
    n_out = N_STATE + (len(S.DIAG_KEYS) if want_rates else 0)
    y = torch.empty((n_out, ncol, nz), dtype=x.dtype, device=x.device)
    ppt = torch.empty((4, ncol), dtype=x.dtype, device=x.device)
    lib = _LIBRARY.get()
    fn = (lib.kid_fused_step_f32 if x.dtype == torch.float32
          else lib.kid_fused_step_f64)
    dt, _ = S._dt_pair(dt_f, x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), ppt.data_ptr(), ncol, nz,
                 int(cfg.iiwarm), int(want_rates), int(cfg.l_sediment),
                 float(cfg.nt_c), dt, float(1 - cfg.ifdry), stream)
    if err != 0:
        raise RuntimeError(f"fused_step kernel launch failed: cudaError {err}")
    fused_step.launches += 1
    return y, ppt


def unpack_outputs(y, ppt, want_rates: bool):
    """(ColumnState, Precip, diag dict) views of the kernel's outputs."""
    state = ColumnState(*y[:N_STATE])
    precip = Precip(*ppt)
    diag = dict(zip(S.DIAG_KEYS, y[N_STATE:])) if want_rates else {}
    return state, precip, diag


def fused_step_ref(state: ColumnState, pres, dzq, tv, cfg: MicroConfig,
                   dt_f: float, want_rates: bool):
    """The plain PyTorch version of the kernel (phases 2-20 of
    ``solver.core_from_tables``) on any device."""
    return S.core_from_tables(state, pres, dzq, tv, cfg, dt_f, want_rates)


def fused_step(state: ColumnState, pres, dzq, tv, cfg: MicroConfig,
               dt_f: float, want_rates: bool):
    """Phases 2-20 of one microphysics step for (ncol, nz) columns.

    ``tv`` holds the table-stage channels (``solver.tv_keys(cfg)``).
    A CPU tensor runs ``fused_step_ref``; a CUDA tensor launches the
    kernel (float32 or float64, nz <= 256, non-aerosol configs) or raises.
    The outputs are new tensors; the input state is not modified.
    Returns (ColumnState, Precip of (ncol,) tensors, diag dict)."""
    dev = state.qv.device
    for t in (*state, pres, dzq, *tv.values()):
        if t.device != dev or t.dtype != state.qv.dtype:
            raise ValueError("fused_step inputs must share one device and "
                             "dtype")
    if dev.type == "cpu":
        return fused_step_ref(state, pres, dzq, tv, cfg, dt_f, want_rates)
    if state.qv.dim() != 2:
        raise ValueError("fused_step takes (ncol, nz) columns")
    y, ppt = launch_packed(pack_inputs(state, pres, dzq, tv, cfg), cfg,
                           dt_f, want_rates)
    return unpack_outputs(y, ppt, want_rates)


fused_step.launches = 0
