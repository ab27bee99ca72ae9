"""Phases 2-20 of the microphysics step as one hand-written CUDA kernel.

``fused_step`` replaces ``kid_tpu/micro/pallas_step.py::fused_step`` (the
Pallas TPU kernel).  For a CUDA tensor it launches the kernel of
``csrc/fused_step.cu``; for a CPU tensor it runs ``fused_step_ref``, the
plain PyTorch version (``solver.core_from_tables``).  There is no fallback
between the two: a CUDA tensor either launches the kernel or raises.

The kernel is built at first use by ``cuda_build`` (nvcc, ``build/`` at
the repository root, keyed by a hash of every kernel source, the
generated constants header and the flags) and bound through a plain C
interface with ``ctypes``.  ``fused_step.launches`` counts the kernel
launches; a CUDA graph's replay adds the launches its capture recorded
(``cuda_build.add_launches``, from ``driver/loop.py``).
"""
from __future__ import annotations

import ctypes

import torch

from ..config import MicroConfig
from . import cuda_build
from . import solver as S
from .state import ColumnState, Precip

N_STATE = len(ColumnState._fields)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_double, ctypes.c_double,
             ctypes.c_double, ctypes.c_void_p]


def _check_cfg(cfg: MicroConfig):
    if cfg.is_aerosol_aware:
        raise ValueError("fused_step takes non-aerosol configs; aerosol-"
                         "aware ones run split_step.fused_rates/fused_post")


def build() -> float:
    """Build (or load) the kernel libraries; returns the build seconds."""
    return cuda_build.build()


def tv_out(state: ColumnState, cfg: MicroConfig):
    """The tv rows of a new packed input (see ``pack_inputs``), for the
    table stage to write into."""
    return cuda_build.tail_rows(N_STATE + 2, len(S.tv_keys(cfg)), state.qv)


def pack_inputs(state: ColumnState, pres, dzq, tv, cfg: MicroConfig):
    """The kernel's one contiguous input, (14 + ntv, ncol, nz): the 12
    state channels, pres, dzq and the ``solver.tv_keys(cfg)`` channels.
    Where ``tv`` holds the rows of ``tv_out``, only the first 14 are
    copied, into the tensor those rows belong to."""
    return cuda_build.pack([*state, pres, dzq],
                           [tv[k] for k in S.tv_keys(cfg)], state.qv.shape)


def launch_packed(x, cfg: MicroConfig, dt_f: float, want_rates: bool):
    """Launch the kernel on the packed input ``x`` (see ``pack_inputs``)
    on the current stream, without synchronising.  Returns ``y``
    (12 [+36], ncol, nz) and ``ppt`` (4, ncol) as new tensors."""
    ncol, nz = cuda_build.check_packed(
        x, N_STATE + 2 + len(S.tv_keys(cfg)), "fused_step")
    _check_cfg(cfg)
    n_out = N_STATE + (len(S.DIAG_KEYS) if want_rates else 0)
    y = torch.empty((n_out, ncol, nz), dtype=x.dtype, device=x.device)
    ppt = torch.empty((4, ncol), dtype=x.dtype, device=x.device)
    fn = cuda_build.kernel_function("fused_step", x.dtype, _ARGTYPES)
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
    _check_cfg(cfg)
    dev = cuda_build.same_device("fused_step", *state, pres, dzq,
                                 *tv.values())
    if dev.type == "cpu":
        return fused_step_ref(state, pres, dzq, tv, cfg, dt_f, want_rates)
    if state.qv.dim() != 2:
        raise ValueError("fused_step takes (ncol, nz) columns")
    y, ppt = launch_packed(pack_inputs(state, pres, dzq, tv, cfg), cfg,
                           dt_f, want_rates)
    return unpack_outputs(y, ppt, want_rates)


fused_step.launches = 0
