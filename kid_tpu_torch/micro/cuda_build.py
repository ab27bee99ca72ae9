"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is one kernel library with a plain C interface.
At first use all of them are compiled with ``nvcc``, one process per file,
all started together, into ``build/kid_tpu_torch/<key>/`` at the
repository root, and loaded with ``ctypes``.  The key hashes every file
under ``csrc/``, the constants header that ``constants_header`` generates
from ``kid_tpu_torch/constants.py`` (one source of truth for the physical
constants) and the compiler flags, so an edit anywhere rebuilds.  A failed
build raises.
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
from .. import spans
from ..special import _RSIF_C, _RSLF_C
from . import solver as S
from .aerosol import _LOG_TA_NA, _LOG_TA_WW, slip_correction

SRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kid_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
MAX_NZ = 256          # one thread per level: the kernels' largest block

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
    """The kernels' constants: every scalar of ``constants.py``, the
    elements of its short 1-D arrays as ``NAME_i``, and the few values the
    solver derives in Python (each computed here exactly as the solver's
    Python computes it)."""
    lines = ["// generated by kid_tpu_torch/micro/cuda_build.py; do not edit",
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
        "RC1": c.R_C_AXIS[0], "RI1": c.R_I_AXIS[0], "NTI1": c.NT_I_AXIS[0],
        "TNC1": c.T_NC[0],       # tables.index.tnc_index's first bin
        # the table stage's log-spaced bins (tables.index.log_bin_index)
        "DR1": c.DR_BINS[0], "DS1": c.DS_BINS[0],
        "RW_SCALE": float(c.NBR) / math.log(S._DRN / S._DR1),
        "SW_SCALE": float(c.NBS) / math.log(S._DSN / S._DS1),
        # the exponential-PSD slopes of the N0 indices (solver._prologue)
        "LAM_EXP_R_FAC": (S.CRG[3] * c.ORG2 * c.ORG1) ** c.BM_R,
        "LAM_EXP_G_FAC": (S.CGG[3] * c.OGG2 * c.OGG1) ** c.BM_G,
        "LAMG_FAC": (S.CGG[3] * c.OGG2 * c.OGG1) ** c.OBMG,
        "D0R_CUBED": c.D0R ** 3,
        "LN10_PY": 2.302585092994046,
        "INV_LN10_PY": 0.4342944819032518,
        "INV_LN10_SNOW": 1.0 / math.log(10.0),
        # eff_aero's slip corrections of its two aerosol diameters
        "SLIP_WFA": slip_correction(0.04e-6),
        "SLIP_IFA": slip_correction(0.8e-6),
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
    # the activation table's log axes, as aerosol.activ_ncloud reads them
    for i, v in enumerate(_LOG_TA_NA):
        derived[f"LOG_TA_NA_{i}"] = v
    for i, v in enumerate(_LOG_TA_WW):
        derived[f"LOG_TA_WW_{i}"] = v
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
                       "the kernels of kid_tpu_torch/micro/csrc")


def build_key(header: str) -> str:
    """Hash of every file under ``csrc/``, the header and the flags."""
    h = hashlib.sha256()
    for path in sorted(SRC_DIR.rglob("*")):
        if path.is_file():
            h.update(path.relative_to(SRC_DIR).as_posix().encode() + b"\0")
            h.update(path.read_bytes() + b"\0")
    h.update(header.encode() + b"\0" + " ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


class _Libraries:
    """The compiled kernel libraries, built once per process (the span
    ``kid.setup.build``: the build, or the load of a build found)."""

    def __init__(self):
        self._libs = None
        self.build_seconds = None

    def get(self, stem: str) -> ctypes.CDLL:
        """The loaded library of ``csrc/<stem>.cu``."""
        if self._libs is None:
            with spans.span("kid.setup.build"):
                self._libs = {k: ctypes.CDLL(str(v))
                              for k, v in self._build().items()}
        return self._libs[stem]

    def _build(self) -> dict:
        header = constants_header()
        out_dir = BUILD_DIR / build_key(header)
        sources = sorted(SRC_DIR.glob("*.cu"))
        sos = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources}
        if all(so.exists() for so in sos.values()):
            self.build_seconds = 0.0
            return sos
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "kid_constants.h").write_text(header)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            procs = {}
            for src in sources:
                tmp_so = Path(tmp) / sos[src.stem].name
                cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(out_dir), "-I",
                       str(SRC_DIR), "-o", str(tmp_so), str(src)]
                procs[src.stem] = (tmp_so, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            errors = []
            for stem, (tmp_so, proc) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed on {stem}.cu:\n{log}")
            if errors:
                raise RuntimeError("\n".join(errors))
            for stem, (tmp_so, _) in procs.items():
                os.replace(tmp_so, sos[stem])
        self.build_seconds = time.perf_counter() - t0
        return sos


LIBRARIES = _Libraries()


def same_device(name: str, *tensors) -> torch.device:
    """The device of ``tensors``; raises unless they share it and a
    dtype."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} inputs must share one device and "
                             "dtype")
    return dev


def check_packed(x, n_in: int, name: str):
    """Raise unless ``x`` is a kernel's packed input: a contiguous
    (n_in, ncol, nz) float32 or float64 CUDA tensor with 2 <= nz <=
    MAX_NZ.  Returns (ncol, nz)."""
    if x.device.type != "cuda":
        raise ValueError(f"launch_packed needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {x.dtype}")
    if x.dim() != 3 or x.shape[0] != n_in:
        raise ValueError(f"packed input must be ({n_in}, ncol, nz), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("packed input must be contiguous")
    _, ncol, nz = x.shape
    if not 2 <= nz <= MAX_NZ or ncol < 1:
        raise ValueError(f"{name} takes 2 <= nz <= {MAX_NZ} and ncol >= 1, "
                         f"got ({ncol}, {nz})")
    return ncol, nz


def tail_rows(n_head: int, n_tail: int, like) -> torch.Tensor:
    """The last ``n_tail`` rows of a new (n_head + n_tail, *like.shape)
    tensor of ``like``'s dtype and device: where the table stage writes
    the channels that a kernel's packed input ends with, so that ``pack``
    copies only the first ``n_head``."""
    buf = torch.empty((n_head + n_tail, *like.shape), dtype=like.dtype,
                      device=like.device)
    return buf[n_head:]


def _is_row(t, base, i: int) -> bool:
    """Whether ``t`` is row ``i`` of ``base``."""
    return (t._base is base and t.shape == base.shape[1:]
            and t.stride() == base.stride()[1:]
            and t.storage_offset() == base.storage_offset()
            + i * base.stride(0))


def _tail_of(tail, n_head: int, shape):
    """The buffer whose last rows ``tail`` are (``tail_rows``), or None."""
    base = tail[0]._base
    if (base is None or tuple(base.shape) != (n_head + len(tail), *shape)
            or not base.is_contiguous()):
        return None
    if not all(_is_row(t, base, n_head + i) for i, t in enumerate(tail)):
        return None
    return base


def pack(head, tail, shape) -> torch.Tensor:
    """A kernel's packed input, one contiguous (len(head) + len(tail),
    *shape) tensor: the ``head`` channels, then the ``tail`` channels,
    each broadcast to ``shape``.  Where ``tail`` is already the last rows
    of such a tensor (``tail_rows``), the head is copied into it, unless
    it already is its first rows (the driver step's, which
    ``driver.advection.advect`` writes there), and it is returned;
    otherwise every channel is stacked into a new one."""
    shape = tuple(shape)
    head = [torch.broadcast_to(t, shape) for t in head]
    base = _tail_of(tail, len(head), shape)
    if base is None:
        return torch.stack(head + [torch.broadcast_to(t, shape)
                                   for t in tail])
    if not all(_is_row(t, base, i) for i, t in enumerate(head)):
        torch.stack(head, out=base[:len(head)])
    return base


def kernel_function(stem: str, dtype, argtypes) -> ctypes._CFuncPtr:
    """C function ``kid_<stem>_f32`` or ``kid_<stem>_f64`` of
    ``csrc/<stem>.cu`` with its argument types set (pointers and the
    stream as ``c_void_p``); it returns the launch's cudaError_t."""
    suffix = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(LIBRARIES.get(stem), f"kid_{stem}_{suffix}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def resources(stem: str, nz: int, dtype, iiwarm: bool,
              want_rates: bool) -> dict:
    """What the card gives the instantiation of ``csrc/<stem>.cu`` that a
    launch at ``nz`` levels takes: registers per thread, local (spill)
    bytes per thread, static shared bytes per block and active blocks per
    SM at its block size (``kid_<stem>_resources``).  For ``table_stage``,
    which has no rate profiles, ``want_rates`` selects the aerosol-aware
    instantiation; for ``advect``, ``iiwarm`` is the number of advected
    tracers and ``want_rates`` the 2-D flag (its shared bytes include the
    tile's slabs)."""
    fn = getattr(LIBRARIES.get(stem), f"kid_{stem}_resources")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    row = (ctypes.c_int * 4)()
    err = fn(nz, int(dtype == torch.float64), int(iiwarm), int(want_rates),
             ctypes.addressof(row))
    if err != 0:
        raise RuntimeError(f"{stem} resources: cudaError {err}")
    return dict(zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"),
                    row))


def build() -> float:
    """Build (or load) every kernel library; returns the build seconds."""
    for src in sorted(SRC_DIR.glob("*.cu")):
        LIBRARIES.get(src.stem)
    return LIBRARIES.build_seconds


def wrappers() -> dict:
    """Every kernel's wrapper by kernel name; each counts its launches in
    ``.launches``."""
    from ..driver import advection
    from . import fused_kid_step, fused_step, split_step, table_stage
    return {"advect": advection.advect,
            "table_stage": table_stage.table_stage,
            "fused_step": fused_step.fused_step,
            "fused_rates": split_step.fused_rates,
            "lookup_stage": split_step.lookup_stage,
            "fused_post": split_step.fused_post,
            "fused_kid_step": fused_kid_step.fused_kid_step}


def reset_launch_counts():
    """Set every kernel's launch count to 0."""
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    """Every kernel's launch count by kernel name."""
    return {k: fn.launches for k, fn in wrappers().items()}


def add_launches(counts: dict, times: int = 1):
    """Add ``times`` x ``counts`` (kernel name -> launches) to the launch
    counts.  The wrappers count when they run, but a CUDA graph's replay
    launches its captured kernels without running them, so the driver loop
    adds a capture's launches once for each replay."""
    for k, fn in wrappers().items():
        fn.launches += times * counts.get(k, 0)


def take_launches(fn) -> dict:
    """Run ``fn()``; returns the launches the wrappers counted during it
    (kernel name -> launches) and takes them back out of the counts: a
    capture launches nothing, and a warm-up's results are thrown away."""
    before = launch_counts()
    fn()
    taken = {k: n - before[k] for k, n in launch_counts().items()}
    add_launches(taken, -1)
    return taken
